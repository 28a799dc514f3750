"""The native agent's (``gpu-hostengine``) CPU time (user + system,
``/proc/<pid>/stat``) over the window, in % of one core."""


def read(run):
    return run.cpu_pct("agent")
