"""Offline analysis of a saved PyTorch profiler trace.

The counterpart of ``tpumon/cli/xplane.py``: point it at a Chrome trace a
workload saved (``torch.profiler``'s ``export_chrome_trace``, or ``python
-m tpumon_torch.loadgen.profile --trace PATH``) and get the monitor's view
of it — per-device duty cycle, the time split by category, peak rates
from the capability table, and the top kernels by self-time.  A saved
trace carries no FLOPs, so the achieved TFLOP/s read n/a.

Usage:
    python -m tpumon_torch.cli.trace trace.json
    python -m tpumon_torch.cli.trace --top 20 --json 'traces/*.json'
"""

from __future__ import annotations

import argparse
import glob
import json
import sys
from typing import Any, Dict, List, Optional, Sequence, Tuple

from .. import trace as T


def infer_window_s(records: List[T.TraceRecord]) -> Optional[float]:
    """Span of the device records (max end - min start) when the capture
    window is unknown.  Duty against it is an UPPER bound — idle time
    before the first and after the last record is invisible — so the
    report labels it 'inferred'."""

    dev = [r for r in records if r.kind == "device"]
    if not dev:
        return None
    lo = min(r.start_ns for r in dev)
    hi = max(r.end_ns for r in dev)
    return (hi - lo) / 1e9 if hi > lo else None


def top_kernels(records: List[T.TraceRecord], device: int,
                n: int) -> List[Tuple[str, float, int]]:
    """Top kernels of one device by leaf self-time -> [(name, s, count)]."""

    counts: Dict[str, int] = {}
    tagged = []
    for r in records:
        if r.kind == "device" and r.device == device:
            counts[r.name] = counts.get(r.name, 0) + 1
            tagged.append((r.start_ns, r.end_ns, r.name))
    ranked = sorted(T.leaf_attribution(tagged).items(),
                    key=lambda kv: -kv[1])[:n]
    return [(name, ns / 1e9, counts[name]) for name, ns in ranked]


def analyze_file(path: str, window_s: Optional[float],
                 top: int) -> List[Dict[str, Any]]:
    records, devices = T.load_kineto_file(path)
    inferred = window_s is None
    if inferred:
        window_s = infer_window_s(records)
    if not window_s:
        return []
    samples = T.analyze(records, window_s, devices)
    out = []
    for dev, s in sorted(samples.items()):
        if s.n_ops == 0:
            continue
        out.append({
            "file": path,
            "device": dev,
            "device_type": s.device_type,
            "window_s": round(window_s, 6),
            "window_inferred": inferred,
            "duty": round(s.duty, 4),
            "busy_s": round(s.busy_s, 6),
            "n_ops": s.n_ops,
            "breakdown": {
                "mxu": round(s.mxu_frac, 4),
                "vector": round(s.vector_frac, 4),
                "data": round(s.data_frac, 4),
                "infeed": round(s.infeed_stall, 4),
                "outfeed": round(s.outfeed_stall, 4),
                "collective": round(s.collective_stall, 4),
            },
            "achieved_tflops": s.achieved_tflops,
            "mxu_tflops": s.mxu_tflops,
            "peak_tflops": s.peak_tflops,
            "peak_hbm_gbps": s.peak_hbm_gbps,
            "exact_categories": s.exact_categories,
            "top_kernels": [{"kernel": name, "self_s": round(sec, 6),
                             "n": cnt}
                            for name, sec, cnt in top_kernels(records, dev,
                                                              top)],
        })
    return out


def render_text(reports: List[Dict[str, Any]],
                out: Optional[Any] = None) -> None:
    out = sys.stdout if out is None else out

    def rate(v: Optional[float]) -> str:
        return f"{v:.1f}" if v is not None else "n/a"

    for r in reports:
        w = "inferred" if r["window_inferred"] else "given"
        print(f"device GPU:{r['device']}"
              f"{' (' + r['device_type'] + ')' if r['device_type'] else ''}"
              f"  window {r['window_s']:.4f}s ({w})", file=out)
        print(f"  duty {r['duty']:.1%}  busy {r['busy_s']:.4f}s  "
              f"records {r['n_ops']}", file=out)
        b = r["breakdown"]
        print(f"  breakdown  mxu {b['mxu']:.1%}  vector {b['vector']:.1%}  "
              f"data {b['data']:.1%}  infeed {b['infeed']:.1%}  "
              f"outfeed {b['outfeed']:.1%}  collective "
              f"{b['collective']:.1%}"
              f"{'  (exact categories)' if r['exact_categories'] else ''}",
              file=out)
        print(f"  compute  peak {rate(r['peak_tflops'])} TFLOP/s  "
              f"achieved {rate(r['achieved_tflops'])}", file=out)
        if r["top_kernels"]:
            print("  top kernels by self-time:", file=out)
            for t in r["top_kernels"]:
                name = (t["kernel"] if len(t["kernel"]) <= 60
                        else t["kernel"][:57] + "...")
                print(f"    {t['self_s'] * 1e3:9.3f} ms  x{t['n']:<5d} "
                      f"{name}", file=out)


def main(argv: Optional[Sequence[str]] = None) -> int:
    p = argparse.ArgumentParser(prog="tpumon-torch-trace",
                                description=__doc__)
    p.add_argument("files", nargs="+",
                   help="Chrome trace files (globs expanded)")
    p.add_argument("--window", type=float, default=None, metavar="SECONDS",
                   help="capture wall window; default: inferred from the "
                        "device records' span (duty then reads as an "
                        "upper bound)")
    p.add_argument("--top", type=int, default=10, metavar="N",
                   help="top-N kernels by leaf self-time (0 disables)")
    p.add_argument("--json", action="store_true",
                   help="one JSON object per device on stdout")
    args = p.parse_args(argv)

    paths: List[str] = []
    for pat in args.files:
        hits = glob.glob(pat)
        paths.extend(hits if hits else [pat])

    reports: List[Dict[str, Any]] = []
    rc = 0
    for path in paths:
        try:
            reports.extend(analyze_file(path, args.window, args.top))
        except (OSError, ValueError) as e:
            print(f"tpumon-torch-trace: {path}: {e}", file=sys.stderr)
            rc = 2
    if not reports and rc == 0:
        print("tpumon-torch-trace: no device records found (a CPU-only "
              "trace, or an empty capture)", file=sys.stderr)
        rc = 1
    if args.json:
        for r in reports:
            print(json.dumps(r))
    else:
        render_text(reports)
    return rc


if __name__ == "__main__":
    sys.exit(main())
