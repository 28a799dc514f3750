"""The job's steps a second over the whole window, by the benchmark's
clock, with the whole deployment running and scraped."""


def read(run):
    return run.window_rate()
