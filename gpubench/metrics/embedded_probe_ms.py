"""The probe's own rounds on the job's thread, ms: the mean, over the
window's inline sweeps that measured a probe, of its readbacks after the
first (two tiny rounds, the matmul chain and the memory stream: the
program's ``sweep.collect.probe.rounds`` span, summed by the window as
``monitor_spans``).  None where the program records no such span."""


def read(run):
    span = ((run.window or {}).get("monitor_spans") or {}).get(
        "sweep.collect.probe.rounds")
    return span["mean_ms"] if span else None
