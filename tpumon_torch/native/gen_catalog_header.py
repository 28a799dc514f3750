"""Generate ``agent/catalog.inc`` from the port's field catalog.

    python -m tpumon_torch.native.gen_catalog_header [--out PATH]

The agent's ``--prom-port`` renderer needs each field's family name, type
and help, and the burst loop its source fields; generating them from
:mod:`tpumon_torch.fields` keeps the native and the Python data planes
from drifting (``tests/test_torch_native_agent.py`` fails when the file
is stale).  Set membership (base, profiling, DCN, burst) follows the
exporter's family selection.
"""

from __future__ import annotations

import argparse
import os
import sys

from .. import fields as FF

OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "agent",
                   "catalog.inc")


def _esc(s: str) -> str:
    return s.replace("\\", "\\\\").replace('"', '\\"')


def render() -> str:
    base = set(int(f) for f in FF.EXPORTER_BASE_FIELDS)
    prof = set(int(f) for f in FF.EXPORTER_PROFILING_FIELDS)
    dcn = set(int(f) for f in FF.EXPORTER_DCN_FIELDS)
    burst = set(int(f) for f in FF.EXPORTER_BURST_FIELDS)
    lines = [
        "// Generated by python -m tpumon_torch.native.gen_catalog_header "
        "from",
        "// tpumon_torch/fields.py.  Do not edit by hand; "
        "tests/test_torch_native_agent.py",
        "// fails when stale.",
        "// set: 1=base 2=profiling 4=dcn 8=burst (bitmask; 0 = api-only)",
        "struct PromFamily {",
        "  int id;",
        "  const char* name;",
        "  const char* ptype;   // \"gauge\" | \"counter\"",
        "  const char* help;",
        "  const char* vector_label;  // \"\" = scalar family",
        "  int set;",
        "};",
        "static const PromFamily kPromCatalog[] = {",
    ]
    for fid in sorted(FF.CATALOG):
        m = FF.CATALOG[fid]
        if m.ftype is FF.FieldType.LABEL:
            continue
        s = ((1 if fid in base else 0) | (2 if fid in prof else 0)
             | (4 if fid in dcn else 0) | (8 if fid in burst else 0))
        lines.append(
            f'    {{{fid}, "{_esc(m.prom_name)}", "{m.ftype.value}", '
            f'"{_esc(m.help)}", "{_esc(m.vector_label)}", {s}}},')
    lines.append("};")
    srcs = ", ".join(str(int(f)) for f in FF.BURST_SOURCE_FIELDS)
    lines += [
        "// Burst-derived field-id scheme (tpumon_torch/fields.py):",
        "//   derived_id = kBurstIdBase + source_id * 4 + agg",
        "// (agg: 0=min 1=max 2=mean 3=integral).",
        f"static const int kBurstIdBase = {FF.BURST_ID_BASE};",
        f"static const int kBurstSourceFields[] = {{{srcs}}};",
        f"static const int kNumBurstSourceFields = "
        f"{len(FF.BURST_SOURCE_FIELDS)};",
    ]
    return "\n".join(lines) + "\n"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", default=OUT)
    args = p.parse_args(argv)
    with open(args.out, "w", encoding="utf-8") as f:
        f.write(render())
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
