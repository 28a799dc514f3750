"""The textfile merge: fresh ``*.prom`` drop files spliced into a scrape.

The node-exporter textfile-collector role, shared by the exporter daemon
(:class:`tpumon_torch.exporter.exporter.TpuExporter`, the reference's
``_merge_textfiles``) and the agent's ``--prom-port`` plane
(:mod:`tpumon_torch.hostengine`, the native agent's ``append_merged``):
a workload's embedded self-monitor output rides a daemon's scrape without
the daemon touching the device.

* Files matching the globs and no older than ``max_age_s`` are read, at
  most :data:`MERGE_MAX_BYTES` each (cut at a line boundary), never
  through a symlink, FIFO or device (the drop directory is
  workload-writable); an unchanged file costs a stat, not a re-parse.
* Each line is validated alone (a torn write drops its line, not the
  file); the scrape's own series win collisions, a family it already
  declares keeps its HELP/TYPE, and across files the first HELP/TYPE wins.
* Merged samples of a family the scrape already emits land inside that
  family's block (OpenMetrics-strict consumers reject split groups);
  everything else appends.

Imports no ``torch``: the agent's process never loads it.
"""

from __future__ import annotations

import glob
import os
import re
import stat
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from .. import log

#: per-file byte cap: the drop dir is workload-writable, and a multi-GB
#: file must not be slurped whole into a scrape
MERGE_MAX_BYTES = 4 << 20

_VALUE_RE = re.compile(
    r"^[+-]?(?:Inf|NaN|[0-9]*\.?[0-9]+(?:[eE][+-]?[0-9]+)?)$")
_TS_RE = re.compile(r"^[+-]?[0-9]+$")


def parse_sample(ln: str) -> Optional[str]:
    """Validate one exposition sample line -> its series identity (name +
    label set), or None if malformed.

    Quote-aware: label values may legally contain ``{``/``}``/spaces, so
    the label section ends at the first unquoted ``}``.  Torn writes and
    garbage return None and are dropped per line."""

    n = len(ln)
    if not n or not (ln[0].isalpha() or ln[0] in "_:"):
        return None
    i = 1
    while i < n and (ln[i].isalnum() or ln[i] in "_:"):
        i += 1
    sid_end = i
    if i < n and ln[i] == "{":
        i += 1
        in_q = False
        esc = False
        while i < n:
            c = ln[i]
            if esc:
                esc = False
            elif c == "\\":
                esc = True
            elif c == '"':
                in_q = not in_q
            elif c == "}" and not in_q:
                break
            i += 1
        if i >= n:
            return None  # unterminated label set (torn write)
        i += 1
        sid_end = i
    if i >= n or ln[i] not in " \t":
        return None
    parts = ln[i:].split()
    if not parts or len(parts) > 2:
        return None
    if not _VALUE_RE.match(parts[0]):
        return None
    if len(parts) == 2 and not _TS_RE.match(parts[1]):
        return None
    return ln[:sid_end]


def series_id(line: str) -> str:
    """Series identity of a known-good sample line (a scrape's own)."""

    sid = parse_sample(line)
    if sid is not None:
        return sid
    brace = line.find("}")
    if brace >= 0:
        return line[:brace + 1]
    return line.split(None, 1)[0]


def index_lines(lines: Iterable[str], series: Set[str],
                decl: Set[str]) -> None:
    """Add a scrape's series and its declared or sampled families to
    ``series`` and ``decl``."""

    for ln in lines:
        if ln.startswith("#"):
            parts = ln.split(None, 3)
            if len(parts) >= 3 and parts[1] in ("HELP", "TYPE"):
                decl.add(parts[2])
        elif ln.strip():
            sid = series_id(ln)
            series.add(sid)
            decl.add(sid.split("{", 1)[0])


def parse_content(content: str) -> List[tuple]:
    """Classify one drop file's lines once; the result is cached on the
    file's stat signature.

    Entry shapes: ``("m", kind, family, line)`` HELP/TYPE metadata,
    ``("c", line)`` other comment, ``("s", sid, family, line)`` valid
    sample, ``("x",)`` malformed (counted as dropped when applied)."""

    entries: List[tuple] = []
    for ln in content.splitlines():
        if ln.startswith("#"):
            parts = ln.split(None, 3)
            if len(parts) >= 3 and parts[1] in ("HELP", "TYPE"):
                entries.append(("m", parts[1], parts[2], ln))
            else:
                entries.append(("c", ln))
            continue
        if not ln.strip():
            continue
        sid = parse_sample(ln)
        if sid is None:
            entries.append(("x",))
            continue
        entries.append(("s", sid, sid.split("{", 1)[0], ln))
    return entries


def splice_lines(lines: List[str],
                 by_family: Dict[str, List[str]]) -> List[str]:
    """Insert merged samples at the close of their family's block in a
    line list, keeping each sample group contiguous; families declared
    but never sampled append at the end.  Consumes ``by_family``."""

    out: List[str] = []
    cur_fam: Optional[str] = None

    def close_family() -> None:
        nonlocal cur_fam
        if cur_fam is not None and cur_fam in by_family:
            out.extend(by_family.pop(cur_fam))
        cur_fam = None

    for ln in lines:
        fam: Optional[str] = None
        if ln.startswith("#"):
            parts = ln.split(None, 3)
            if len(parts) >= 3 and parts[1] in ("HELP", "TYPE"):
                fam = parts[2]
        elif ln.strip():
            fam = series_id(ln).split("{", 1)[0]
        if fam is not None and fam != cur_fam:
            close_family()
            cur_fam = fam
        out.append(ln)
    close_family()
    for rest in by_family.values():
        out.extend(rest)
    by_family.clear()
    return out


class TextfileMerge:
    """The drop files of ``globs`` no older than ``max_age_s``, merged
    into a scrape.  ``exclude``: a path never merged (the exporter's own
    output, which its glob may match).  ``files``/``series``/``families``
    describe the last merge, for the self-metrics."""

    def __init__(self, globs: Sequence[str], max_age_s: float = 60.0,
                 exclude: Optional[str] = None) -> None:
        self.globs = list(globs)
        self.max_age_s = max_age_s
        self.exclude = os.path.abspath(exclude) if exclude else None
        self.max_bytes = MERGE_MAX_BYTES
        #: fresh files merged, samples merged, families they carried
        self.files = 0
        self.series = 0
        self.families: Set[str] = set()
        #: drop-file parse cache: path -> ((mtime_ns, size, inode),
        #: parsed entries)
        self.cache: Dict[str, Tuple[Tuple[int, int, int], List[tuple]]] = {}
        #: the parser (a seam for tests that count parses)
        self.parse = parse_content

    def read(self, path: str) -> Optional[str]:
        """Bounded, non-blocking read of one drop file.

        O_NONBLOCK so a FIFO cannot park the caller in open(2),
        O_NOFOLLOW + S_ISREG so a symlink (to /dev/zero, say) is skipped,
        and a hard byte cap with the truncated tail cut at a line
        boundary.  None when the file should be skipped."""

        flags = os.O_RDONLY | getattr(os, "O_NONBLOCK", 0) | \
            getattr(os, "O_NOFOLLOW", 0)
        fd = os.open(path, flags)
        try:
            st = os.fstat(fd)
            if not stat.S_ISREG(st.st_mode):
                log.warn_every("exporter.merge.notreg", 60.0,
                               "merge path %s is not a regular file "
                               "(mode %o); skipped", path, st.st_mode)
                return None
            chunks: List[bytes] = []
            remaining = self.max_bytes + 1
            while remaining > 0:
                chunk = os.read(fd, min(remaining, 1 << 20))
                if not chunk:
                    break
                chunks.append(chunk)
                remaining -= len(chunk)
            data = b"".join(chunks)
        finally:
            os.close(fd)
        if len(data) > self.max_bytes:
            cut = data.rfind(b"\n", 0, self.max_bytes)
            data = data[:cut + 1 if cut >= 0 else 0]
            log.warn_every("exporter.merge.truncated", 60.0,
                           "merge textfile %s exceeds %d bytes; "
                           "truncated", path, self.max_bytes)
        return data.decode("utf-8", "replace")

    # tpumon: thread-ok(one consumer per merge — the exporter merges on its sweep thread, and the Python agent's scrapes merge under Engine._prom_lock; the call graph joins the two instances)
    def load(self, now: float) -> List[List[tuple]]:
        """Fresh drop files' parsed entries (setting :attr:`files`), with
        the parse cached on ``(path, mtime_ns, size, inode)``."""

        files = 0
        out: List[List[tuple]] = []
        seen_paths: Set[str] = set()
        for pattern in self.globs:
            for path in sorted(glob.glob(pattern)):
                if self.exclude and os.path.abspath(path) == self.exclude:
                    continue  # never merge our own output back in
                try:
                    st = os.stat(path, follow_symlinks=False)
                    if not stat.S_ISREG(st.st_mode):
                        # FIFO/symlink planted in the workload-writable
                        # drop dir: never even open it
                        log.warn_every("exporter.merge.notreg", 60.0,
                                       "merge path %s is not a regular "
                                       "file (mode %o); skipped",
                                       path, st.st_mode)
                        continue
                    age = now - st.st_mtime
                    if age > self.max_age_s:
                        log.warn_every("exporter.merge.stale", 60.0,
                                       "stale textfile %s (%.0fs old) "
                                       "skipped", path, age)
                        continue
                    sig = (st.st_mtime_ns, st.st_size, st.st_ino)
                    cached = self.cache.get(path)
                    if cached is not None and cached[0] == sig:
                        entries = cached[1]
                    else:
                        content = self.read(path)
                        if content is None:
                            continue
                        entries = self.parse(content)
                        self.cache[path] = (sig, entries)
                except OSError as e:
                    log.warn_every("exporter.merge.read", 60.0,
                                   "merge textfile %s unreadable: %r",
                                   path, e)
                    continue
                seen_paths.add(path)
                files += 1
                out.append(entries)
        # evict entries whose file left the glob (pod churn names drop
        # files by pod UID — the cache must not grow without bound)
        for path in [p for p in self.cache if p not in seen_paths]:
            del self.cache[path]
        self.files = files
        if not out:
            self.series, self.families = 0, set()
        return out

    # tpumon: thread-ok(one consumer per merge — the exporter merges on its sweep thread, and the Python agent's scrapes merge under Engine._prom_lock; the call graph joins the two instances)
    def apply(self, series: Set[str], decl: Set[str],
              files_entries: List[List[tuple]],
              ) -> Tuple[Dict[str, List[str]], List[str]]:
        """Dedup parsed drop-file entries against the scrape's series and
        family index (updating :attr:`series` and :attr:`families`).
        Returns ``(by_family, tail_lines)``: merged samples joining a
        family the scrape already emits, and everything else."""

        by_family: Dict[str, List[str]] = {}
        tail_lines: List[str] = []
        seen_meta: Set[Tuple[str, str]] = set()  # (kind, family)
        merged_fams: Set[str] = set()
        merged = 0
        dropped = 0
        for entries in files_entries:
            for e in entries:
                kind = e[0]
                if kind == "s":
                    _, sid, fam, ln = e
                    if sid in series:
                        continue  # the scrape's own sample wins
                    series.add(sid)
                    merged += 1
                    merged_fams.add(fam)
                    if fam in decl:
                        by_family.setdefault(fam, []).append(ln)
                    else:
                        tail_lines.append(ln)
                elif kind == "m":
                    # a family the scrape already declared or sampled
                    # keeps ITS metadata; across files the first wins
                    _, mkind, fam, ln = e
                    key = (mkind, fam)
                    if fam in decl or key in seen_meta:
                        continue
                    seen_meta.add(key)
                    tail_lines.append(ln)
                elif kind == "c":
                    tail_lines.append(e[1])
                else:
                    dropped += 1
        if dropped:
            log.warn_every("exporter.merge.malformed", 60.0,
                           "%d malformed merge line(s) dropped "
                           "(non-atomic writer?)", dropped)
        self.series = merged
        self.families = merged_fams
        return by_family, tail_lines

    def merge_text(self, text: str, now: float) -> str:  # tpumon-lint: disable=encode-in-hot-path
        """A whole exposition with the fresh drop files merged in: the
        full-text merge (the exporter's oracle/enricher fallback, and the
        agent's scrape), which re-indexes the text because an enricher may
        have rewritten it.  The exporter's hot loop merges by parts
        (``TpuExporter._merge_textfiles_parts``)."""

        series: Set[str] = set()
        decl: Set[str] = set()  # families declared OR sampled by the text
        index_lines(text.splitlines(), series, decl)
        by_family, tail_lines = self.apply(series, decl, self.load(now))
        if not by_family and not tail_lines:
            return text
        out = text
        if by_family:
            out = "\n".join(splice_lines(text.splitlines(), by_family)) + "\n"
        if tail_lines:
            out = out + "\n".join(tail_lines) + "\n"
        return out
