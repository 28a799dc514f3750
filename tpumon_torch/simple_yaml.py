"""The YAML subset the anomaly rules files, the chaos scenarios and the
GPU deployment manifests use.

The port's copy of ``parse_simple_yaml`` and its helpers from
``tpumon/chaos.py``; the port's chaos harness (:mod:`tpumon_torch.chaos`)
imports them from here: nested mappings, ``- `` lists (of scalars or
mappings), scalars (int/float/bool/null/quoted/bare strings) and
one-line flow lists.  The files stay valid YAML, but no YAML package is
needed.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple


def _parse_scalar(text: str) -> Any:
    t = text.strip()
    if t in ("null", "~", ""):
        return None
    if t in ("true", "True"):
        return True
    if t in ("false", "False"):
        return False
    if (t.startswith('"') and t.endswith('"') and len(t) >= 2) or \
            (t.startswith("'") and t.endswith("'") and len(t) >= 2):
        return t[1:-1]
    if t.startswith("[") and t.endswith("]"):
        inner = t[1:-1].strip()
        if not inner:
            return []
        return [_parse_scalar(p) for p in inner.split(",")]
    try:
        return int(t, 0)
    except ValueError:
        pass
    try:
        return float(t)
    except ValueError:
        pass
    return t


def _strip_comment(line: str) -> str:
    # a # starts a comment unless inside quotes (scenario strings are
    # simple; quote-aware enough for this corpus)
    out = []
    quote = ""
    for ch in line:
        if quote:
            out.append(ch)
            if ch == quote:
                quote = ""
            continue
        if ch in "\"'":
            quote = ch
            out.append(ch)
            continue
        if ch == "#":
            break
        out.append(ch)
    return "".join(out).rstrip()


def _split_key(content: str, where: str) -> Tuple[str, str]:
    # key: rest — the colon must be followed by space/EOL (flow lists
    # and URLs inside values keep their colons)
    for i, ch in enumerate(content):
        if ch == ":" and (i + 1 == len(content)
                          or content[i + 1] in " \t"):
            return content[:i].strip(), content[i + 1:].strip()
    raise ValueError(f"expected 'key: value' {where}: {content!r}")


def parse_simple_yaml(text: str) -> Any:
    """Parse the YAML subset rules files use: nested mappings,
    ``- `` lists (of scalars or mappings), scalars (int/float/bool/
    null/quoted/bare strings) and one-line flow lists.  Raises
    ``ValueError`` with a line number on anything else."""

    lines: List[Tuple[int, int, str]] = []  # (lineno, indent, content)
    for no, raw in enumerate(text.splitlines(), 1):
        stripped = _strip_comment(raw)
        if not stripped.strip():
            continue
        if "\t" in raw[:len(raw) - len(raw.lstrip())]:
            raise ValueError(f"line {no}: tabs in indentation")
        lines.append((no, len(stripped) - len(stripped.lstrip()),
                      stripped.strip()))

    def parse_block(i: int, indent: int) -> Tuple[Any, int]:
        if i >= len(lines) or lines[i][1] < indent:
            return None, i
        if lines[i][2].startswith("- ") or lines[i][2] == "-":
            return parse_list(i, lines[i][1])
        return parse_map(i, lines[i][1])

    def parse_list(i: int, indent: int) -> Tuple[List[Any], int]:
        out: List[Any] = []
        while i < len(lines) and lines[i][1] == indent and \
                (lines[i][2].startswith("- ") or lines[i][2] == "-"):
            no, _ind, content = lines[i]
            body = content[2:].strip() if content != "-" else ""
            if not body:
                item, i = parse_block(i + 1, indent + 1)
                out.append(item)
                continue
            if ":" in body:
                try:
                    key, rest = _split_key(body, f"at line {no}")
                except ValueError:
                    out.append(_parse_scalar(body))
                    i += 1
                    continue
                # "- key: value" opens a mapping; following lines
                # indented past the dash extend it
                mapping: Dict[str, Any] = {}
                if rest:
                    mapping[key] = _parse_scalar(rest)
                    i += 1
                else:
                    sub, i = parse_block(i + 1, indent + 3)
                    mapping[key] = sub
                if i < len(lines) and lines[i][1] > indent and \
                        not (lines[i][2].startswith("- ")
                             or lines[i][2] == "-"):
                    more, i = parse_map(i, lines[i][1])
                    mapping.update(more)
                out.append(mapping)
            else:
                out.append(_parse_scalar(body))
                i += 1
        return out, i

    def parse_map(i: int, indent: int) -> Tuple[Dict[str, Any], int]:
        out: Dict[str, Any] = {}
        while i < len(lines) and lines[i][1] == indent and \
                not lines[i][2].startswith("- "):
            no, _ind, content = lines[i]
            key, rest = _split_key(content, f"at line {no}")
            if rest:
                out[key] = _parse_scalar(rest)
                i += 1
            else:
                sub, i = parse_block(i + 1, indent + 1)
                out[key] = sub
        return out, i

    value, i = parse_block(0, 0)
    if i != len(lines):
        raise ValueError(f"line {lines[i][0]}: unexpected structure")
    return value
