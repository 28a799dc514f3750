"""The 95th percentile of a scrape's wait inside the native agent, from
its accept to the scrape lock (the handler thread's start, the request's
headers, a scrape ahead of it), ms, over the window's scrapes: each body
carries its own (``tpumon_agent_scrape_wait_ms``).  None where the agent
does not serve the node's scrape or serves no such phase."""

from gpubench.metrics.agent_scrape_collect_p95_ms import p95_of


def read(run):
    return p95_of(run, "tpumon_agent_scrape_wait_ms")
