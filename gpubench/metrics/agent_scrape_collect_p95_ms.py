"""The 95th percentile of a scrape's collect inside the native agent (the
burst harvest, the watch cache and the live NVML reads of every card),
ms, over the window's scrapes: each body carries its own
(``tpumon_agent_scrape_collect_ms``).  None where the agent does not
serve the node's scrape or serves no such phase."""

from gpubench.reference.promtext import samples
from gpubench.stats import percentile


def p95_of(run, family):
    """The 95th percentile of an agent's per-scrape gauge ``family`` over
    the window's served scrapes."""

    if run.config["scrape"]["role"] != "agent":
        return None
    values = []
    for rec in run.scrapes["records"]:
        if rec.get("ok"):
            values += [float(v) for (fam, _), v in samples(rec["body"]).items()
                       if fam == family]
    return percentile(values, 95)


def read(run):
    return p95_of(run, "tpumon_agent_scrape_collect_ms")
