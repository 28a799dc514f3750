"""The mean wall of the embedded monitor's sweeps inside the window, as
the job's thread pays it, ms."""


def read(run):
    t0, t1 = run.window_start, run.window_start + run.seconds
    walls = [e - s for s, e in run.sweeps if t0 <= s < t1]
    return 1000.0 * sum(walls) / len(walls) if walls else None
