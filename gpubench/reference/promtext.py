"""The Prometheus text exposition format, read by a plain parser, and the
merge a node's scrape owes the workload's drop file.

A drop file (the workload's embedded monitor output) is spliced into the
node's scrape: every sample of it is served, unless the node serves a
series of the same name and labels itself, which then wins.  The check
holds a scrape to one version of the drop file, the one it matches best.
"""

from __future__ import annotations

import re
from typing import Dict, Iterable, List, Optional, Set, Tuple

_NAME = re.compile(r"[A-Za-z_:][A-Za-z0-9_:]*")
_LABEL = re.compile(r'([A-Za-z_][A-Za-z0-9_]*)="((?:[^"\\]|\\.)*)"')


def parse_line(line: str) -> Optional[Tuple[str, Tuple[Tuple[str, str], ...],
                                            str]]:
    """(family, sorted labels, value text) of one sample line; None for a
    comment, a blank line or a malformed one."""

    line = line.strip()
    if not line or line.startswith("#"):
        return None
    m = _NAME.match(line)
    if m is None:
        return None
    name, rest = m.group(0), line[m.end():]
    labels: List[Tuple[str, str]] = []
    if rest.startswith("{"):
        pos = 1
        while True:
            while pos < len(rest) and rest[pos] in " ,":
                pos += 1
            if pos >= len(rest):
                return None
            if rest[pos] == "}":
                pos += 1
                break
            lm = _LABEL.match(rest, pos)
            if lm is None:
                return None
            labels.append((lm.group(1), lm.group(2)))
            pos = lm.end()
        rest = rest[pos:]
    parts = rest.split()
    if not parts or len(parts) > 2:
        return None
    try:
        float(parts[0])
    except ValueError:
        return None
    return name, tuple(sorted(labels)), parts[0]


def samples(text: str) -> Dict[Tuple[str, Tuple[Tuple[str, str], ...]], str]:
    """Series (family, labels) -> value text of a body."""

    out = {}
    for line in text.splitlines():
        got = parse_line(line)
        if got is not None:
            out[(got[0], got[1])] = got[2]
    return out


def families(text: str) -> Set[str]:
    return {k[0] for k in samples(text)}


def card_families(body: Dict, uuid: str) -> Set[str]:
    """Families of a parsed body with a sample labelled with the card's
    ``uuid``."""

    return {fam for fam, labels in body
            if ("uuid", uuid) in labels}


def merge_mismatches(body: Dict, drops: Iterable[Dict],
                     own_series: Set) -> Tuple[int, int]:
    """(mismatched samples, index of the drop version matched) of one
    parsed scrape body against the recorded versions of the drop file.

    The version matched is the one with the most samples served exactly.
    Against it, a drop sample is mismatched when the body lacks its
    series, or serves it with another value where the node does not
    serve that series itself (``own_series``: the node's own series, read
    before any drop file existed): there the node's own series wins."""

    best = (-1, -1, 0)
    for i, drop in enumerate(drops):
        exact = sum(1 for k, v in drop.items() if body.get(k) == v)
        if exact > best[0]:
            bad = sum(1 for k, v in drop.items()
                      if k not in body or (body[k] != v
                                           and k not in own_series))
            best = (exact, i, bad)
    if best[1] < 0:
        return 0, -1
    return best[2], best[1]


def card_values(body: Dict, family: str, uuid: str,
                series: Set) -> List[str]:
    """Values of ``family`` that a parsed body serves for the card
    ``uuid`` under one of ``series`` (the node's own)."""

    return [v for (fam, labels), v in body.items()
            if fam == family and ("uuid", uuid) in labels
            and (fam, labels) in series]
