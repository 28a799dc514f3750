"""The Python exporter's largest resident set over the window (``VmRSS``
sampled at 10 Hz), MiB."""


def read(run):
    return run.rss_mib("exporter")
