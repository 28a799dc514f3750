"""The comparison that decides ``correct``: what the timed path produced,
against the plain references under ``reference/``.

* The job: what its kind's module (``kinds/<kind>.py``) compares, e.g.
  the train step's first steps through the window's own call against
  the reference's SGD, or a pattern's steps drawn from the seed, each
  output against the reference's from the same input.
* The node's served text: every scrape due in the window served, with
  the card's families; each against the drop file's versions
  (``reference.promtext.merge_mismatches``) and the card's memory total
  against ``nvidia-smi``'s.

Each number is held to its limit in the traffic mix's ``limits``; the
control (``control.py``) reads the same numbers with the reference in
fp8 in the program's place.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

from .reference import promtext as RP


def job_numbers(job, traffic: Dict, device) -> Dict[str, Optional[float]]:
    """The job's numbers compared, of what its timed path produced (its
    kind's ``numbers``)."""

    return job.impl.numbers(job, traffic["workload"], traffic["check"],
                            device)


def monitor_numbers(scrapes: Dict, own_series, uuid: str,
                    min_card_families: int, due: int,
                    hbm_total_mib: Optional[int], alter=None
                    ) -> Tuple[Dict[str, Optional[float]], int]:
    """(numbers compared, scrapes failed) of the window's scrapes.

    A scrape is served when it came back in time with at least
    ``min_card_families`` families of the card; every one of the ``due``
    scrapes that was not (it errored, timed out, lacked the card's
    families, or was never made) has failed, and ``scrapes_not_served``
    counts them.  Each served scrape's merged samples are held to the
    drop file's versions (``merge_mismatches``), and the card's memory
    total that the node serves of itself to the card's own reading by
    ``nvidia-smi``, in MiB (``hbm_total_mismatches``: served scrapes
    without it or with another value).  ``alter`` rewrites each parsed
    body before the comparison (the control's rounding)."""

    drops = [RP.samples(v["text"]) for v in scrapes["drops"]]
    drops = [d for d in drops if d]
    own = set(own_series)
    mismatched = 0
    hbm_bad = 0
    answered = 0
    for rec in scrapes["records"]:
        if not rec.get("ok"):
            continue
        body = RP.samples(rec["body"])
        if len(RP.card_families(body, uuid)) < min_card_families:
            continue
        answered += 1
        if alter is not None:
            body = alter(body)
        bad, _ = RP.merge_mismatches(body, drops, own)
        mismatched += bad
        totals = RP.card_values(body, "tpu_hbm_total", uuid, own)
        if not totals or any(float(v) != hbm_total_mib for v in totals):
            hbm_bad += 1
    failed = max(due, len(scrapes["records"])) - answered
    return ({"merge_mismatches": float(mismatched) if drops else None,
             "hbm_total_mismatches": float(hbm_bad)
             if hbm_total_mib is not None else None,
             "scrapes_not_served": float(failed),
             "scrapes_compared": float(answered)}, failed)
