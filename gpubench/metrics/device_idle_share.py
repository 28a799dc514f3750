"""The share of a profiler stretch of the job's thread in which the card
ran nothing, in %."""


def read(run):
    if run.stretch is None:
        return None
    return 100.0 * (1.0 - run.stretch["busy_s"] / run.stretch["window_s"])
