"""Order statistics the benchmark reports, over all samples of a window."""

from __future__ import annotations

import math
import statistics
from typing import Iterable, List, Optional, Sequence


def percentile(values: Sequence[float], pct: int) -> Optional[float]:
    """The ``pct``-th percentile by ``statistics.quantiles(n=100)``; None
    for fewer than two values."""

    if len(values) < 2:
        return None
    return statistics.quantiles(values, n=100)[pct - 1]


def scrape_latencies_ms(records: Iterable[dict], timeout_s: float
                        ) -> List[float]:
    """Every scrape's latency in ms, from when it was due to the body's
    last byte; a scrape that failed counts at the timeout."""

    out = []
    for r in records:
        if r.get("ok"):
            out.append(1000.0 * (r["end"] - r["due"]))
        else:
            out.append(1000.0 * timeout_s)
    return out


def scrapes_due(scrapers: int, hz: float, seconds: float) -> int:
    """Scrapes due in a window: each client's at 0, 1/hz, ... before
    ``seconds``."""

    return scrapers * math.ceil(seconds * hz - 1e-9)
