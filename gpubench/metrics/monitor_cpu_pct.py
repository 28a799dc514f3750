"""The CPU time (user + system, ``/proc/<pid>/stat``) of the node's
monitor processes (the configuration's: ``gpu-hostengine``, and the
exporter where it runs) over the window, in % of one core."""


def read(run):
    return sum(map(run.cpu_pct_of, run.scrapes["cpu_s"]))
