"""The 95th percentile of a scrape's wait inside the Python exporter,
from its accept to its handler (a thread, the interpreter lock, the
request's headers), ms: each request once, as the exporter serves the
latest one's phases (``tpumon_exporter_request_phase_seconds``,
``phase="wait"``), counted by ``tpumon_exporter_requests_total``.  None
where the exporter does not serve the node's scrape or serves no phase."""

from gpubench.reference.promtext import samples
from gpubench.stats import percentile

PHASES = "tpumon_exporter_request_phase_seconds"
REQUESTS = "tpumon_exporter_requests_total"


def read(run):
    if run.config["scrape"]["role"] != "exporter":
        return None
    waits = {}
    for rec in run.scrapes["records"]:
        if not rec.get("ok"):
            continue
        body = samples(rec["body"])
        wait = [float(v) for (fam, labels), v in body.items()
                if fam == PHASES and ("phase", "wait") in labels]
        count = [v for (fam, _), v in body.items() if fam == REQUESTS]
        if wait and count:
            waits[count[0]] = 1000.0 * wait[0]
    return percentile(list(waits.values()), 95)
