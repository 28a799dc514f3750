"""The probe's first readback on the job's thread, ms: the mean, over the
window's inline sweeps that measured a probe, of its first tiny round
(the program's ``sweep.collect.probe.drain`` span, summed by the window
as ``monitor_spans``).  It runs after the sweep's ``hbm_stats`` read,
whose ``cudaMemGetInfo`` has already waited for the steps the job had
queued, so on the card it reads one more tiny round, not that wait.
None where the program records no such span."""


def read(run):
    span = ((run.window or {}).get("monitor_spans") or {}).get(
        "sweep.collect.probe.drain")
    return span["mean_ms"] if span else None
