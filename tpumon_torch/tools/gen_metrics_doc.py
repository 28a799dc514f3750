#!/usr/bin/env python3
"""Generate tpumon_torch/docs/metrics.md from the port's field catalog
(tpumon_torch/fields.py).

    python -m tpumon_torch.tools.gen_metrics_doc [--out PATH]

Run after changing the catalog: ``python -m tpumon_torch.tools.tpumon_lint``
(``catalog-doc-sync``) fails while the two disagree.  The catalog is the
single source of truth and the doc is derived from it, as the JAX
package's ``docs/metrics.md`` is from its own.
"""

from __future__ import annotations

import os
import sys
from typing import List, Optional, Sequence

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from tpumon_torch import fields as FF  # noqa: E402

OUT = os.path.join(REPO, "tpumon_torch", "docs", "metrics.md")


def _family_table(families) -> List[str]:
    lines = ["", "| Family | Type | Meaning |", "|--------|------|---------|"]
    for fam, ptype, help_txt in families:
        lines.append(f"| `{fam}` | {ptype} | {help_txt} |")
    return lines


def render() -> str:
    base = set(FF.EXPORTER_BASE_FIELDS)
    prof = set(FF.EXPORTER_PROFILING_FIELDS)
    dcn = set(FF.EXPORTER_DCN_FIELDS)
    burst = set(FF.EXPORTER_BURST_FIELDS)

    def setname(fid: int) -> str:
        if fid in base:
            return "base"
        if fid in prof:
            return "profiling (-p)"
        if fid in dcn:
            return "dcn (--dcn)"
        if fid in burst:
            return "burst (--burst)"
        return "api-only"

    lines = [
        "# Metric catalog (the port)",
        "",
        "Generated by `python -m tpumon_torch.tools.gen_metrics_doc` from"
        " `tpumon_torch/fields.py` — do not edit by hand"
        " (`python -m tpumon_torch.tools.tpumon_lint` enforces sync).",
        "",
        "Field IDs are stable and the same as the JAX package's, so"
        " dashboards carry over. `label`-type fields are identity"
        " attributes, exported as labels rather than samples. Vector"
        " fields emit one sample per element with the extra label named"
        " in the vector column.",
        "",
        "| ID | Name | Prometheus family | Type | Unit | Vector | Set |"
        " Description |",
        "|---:|------|-------------------|------|------|--------|-----|"
        "-------------|",
    ]
    for fid in sorted(FF.CATALOG):
        m = FF.CATALOG[fid]
        lines.append(
            f"| {fid} | {m.name} | `{m.prom_name}` | {m.ftype.value} |"
            f" {m.unit or '—'} | {m.vector_label or '—'} | {setname(fid)} |"
            f" {m.help} |")
    srcs = ", ".join(str(s) for s in FF.BURST_SOURCE_FIELDS)
    lines += [
        "",
        f"Totals: {len(FF.CATALOG)} fields — {len(base)} base,"
        f" {len(prof)} profiling, {len(dcn)} DCN,"
        f" {len(burst)} burst-derived.",
        "",
        "Burst-derived families (`*_1s_min/_1s_max/_1s_mean/"
        "_1s_integral`, set `burst`) are windowed accumulators over a"
        " 50-100 Hz inner sampling loop (`--burst-hz` on the agents and"
        " the exporter): each second, the min/max/mean/time-integral of"
        " the high-rate samples of a source field (ids"
        f" {srcs}) folds into the 1 Hz sweep."
        " Ids are arithmetic:"
        f" `derived = {FF.BURST_ID_BASE} + source_id * 4 + agg`"
        " (agg 0=min 1=max 2=mean 3=integral).",
        "",
        "Exporter self-metrics (`tpumon_exporter_*`) and agent"
        " self-metrics (`tpumon_agent_*`) are written in"
        " `tpumon_torch/exporter/exporter.py` and"
        " `tpumon_torch/hostengine.py`; they carry a `{host}` label"
        " instead of `{chip,uuid,model}`. Flight-recorder self-metrics"
        " (`tpumon_blackbox_*`) are listed in"
        " `tpumon_torch/docs/blackbox.md`.",
        "",
        "Detection-plane self-metrics (`tpumon_anomaly_*` /"
        " `tpumon_incident_*`, with `--rules`), rendered from the"
        " registration the exporter emits from"
        " (`tpumon_torch.anomaly.METRIC_FAMILIES`):",
    ]
    from tpumon_torch.anomaly import METRIC_FAMILIES
    lines += _family_table(METRIC_FAMILIES)
    lines += [
        "",
        "Stream-relay self-metrics (`tpumon_relay_*`, served by"
        " `python -m tpumon_torch.cli.relay --metrics-port P`), rendered"
        " from `tpumon_torch.relay.METRIC_FAMILIES`:",
    ]
    from tpumon_torch.relay import METRIC_FAMILIES as RELAY_FAMILIES
    lines += _family_table(RELAY_FAMILIES)
    lines += [
        "",
        "Timing self-metrics: the exporter's sweep phases and its latest"
        " served `/metrics` request's phases, read from its spans"
        " (`tpumon_torch.spans`) and served one sweep late"
        " (`tpumon_torch.exporter.exporter.SELF_FAMILIES`), and the"
        " agents' `--prom-port` scrape phases"
        " (`tpumon_torch.hostengine.SCRAPE_PHASES`, the same in"
        " `gpu-hostengine`). An agent serves its own scrape's phases but"
        " the write, the previous scrape's; its wait, collect, render and"
        " merge fit in the scrape's wall, `render_ms` being the formatting"
        " alone:",
    ]
    from tpumon_torch.exporter.exporter import SELF_FAMILIES
    from tpumon_torch.hostengine import SCRAPE_PHASES
    lines += _family_table(
        [(fam, ptype, help_txt)
         for fam, (ptype, help_txt) in SELF_FAMILIES.items()]
        + [(fam, "gauge", help_txt) for fam, help_txt in SCRAPE_PHASES])
    lines.append("")
    return "\n".join(lines)


def main(argv: Optional[Sequence[str]] = None) -> int:
    import argparse

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--out", default=OUT,
                   help="output path (default: tpumon_torch/docs/metrics.md)")
    args = p.parse_args(argv)
    text = render()
    with open(args.out, "w", encoding="utf-8") as f:
        f.write(text)
    print(f"wrote {args.out} ({len(text.splitlines())} lines)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
