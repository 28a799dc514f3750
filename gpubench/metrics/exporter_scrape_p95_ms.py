"""The 95th percentile of every scrape due in the window, due time to
last byte (a failed one at the timeout), where the Python exporter
serves the node's scrape (``MetricsHTTPServer``), ms."""

from gpubench.stats import percentile


def read(run):
    if run.config["scrape"]["role"] != "exporter":
        return None
    return percentile(run.latencies_ms(), 95)
