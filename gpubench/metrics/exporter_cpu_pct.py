"""The Python exporter's CPU time (user + system, ``/proc/<pid>/stat``)
over the window, in % of one core; None on a node without it."""


def read(run):
    return run.cpu_pct("exporter")
