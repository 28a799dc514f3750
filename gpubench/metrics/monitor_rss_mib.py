"""The sum over the monitor processes of their largest resident set
(``VmRSS``, sampled at 10 Hz over the window), MiB."""


def read(run):
    return sum(run.scrapes["rss_peak_kib"].values()) / 1024.0
