"""The Python exporter's sweep, ms: the median over the window's sweeps
of the sum of its phases (collect, render, merge, publish, ...), as the
exporter serves them of its previous sweep
(``tpumon_exporter_sweep_phase_seconds``), each sweep counted once (by
``tpumon_exporter_sweeps_total``).  None where no scrape carried them:
a node without the exporter."""

import statistics

from gpubench.reference.promtext import samples

PHASES = "tpumon_exporter_sweep_phase_seconds"
SWEEPS = "tpumon_exporter_sweeps_total"


def read(run):
    walls = {}
    for rec in run.scrapes["records"]:
        if not rec.get("ok"):
            continue
        body = samples(rec["body"])
        phases = [float(v) for (fam, _), v in body.items() if fam == PHASES]
        count = [v for (fam, _), v in body.items() if fam == SWEEPS]
        if phases and count:
            walls[count[0]] = 1000.0 * sum(phases)
    return statistics.median(walls.values()) if walls else None
