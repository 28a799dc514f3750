"""The 95th percentile of every scrape due in the window, each from when
it was due to its body's last byte; a failed scrape counts at the
timeout."""

from gpubench.stats import percentile


def read(run):
    return percentile(run.latencies_ms(), 95)
