"""The node's Prometheus consumers, in a process of their own.

``python -m gpubench.scrape`` reads one JSON line of settings on standard
input, starts recording every version of the workload's drop file, and
waits for a second line, ``go <t>``, with ``t`` the window's start on the
monotonic clock (shared by the processes of one machine).  Then
``scrapers`` independent clients GET the endpoint at ``hz`` each, in an
open loop: client i's k-th scrape is due at a point of its k-th period
(t + (k + u)/hz, u uniform in [0, 1) from the seed, so that no client
stays in step with the node's own 1 Hz sweep) and is timed from then to
its body's last byte, however late it was sent.
Over [t, t + seconds] it reads the CPU time of the monitor's processes
and samples their resident sets, from ``/proc``.  It writes one JSON file of
everything it saw and exits.  It imports neither torch nor the program.
"""

from __future__ import annotations

import http.client
import json
import os
import random
import sys
import threading
import time
from typing import Dict, List

from gpubench.reference.promtext import parse_line
from gpubench.run import REFUSED

#: how often the monitor processes' resident sets are read
RSS_HZ = 10.0


def proc_cpu_s(pid: int) -> float:
    """utime + stime of a process, in seconds."""

    with open(f"/proc/{pid}/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    return (int(fields[11]) + int(fields[12])) / os.sysconf("SC_CLK_TCK")


def proc_rss_kib(pid: int) -> int:
    """Resident set (``VmRSS``) of a process, KiB."""

    with open(f"/proc/{pid}/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1])
    raise KeyError(f"no VmRSS for pid {pid}")


def get(port: int, path: str, timeout: float):
    """(status, body text) of one GET on localhost."""

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request("GET", path)
        r = conn.getresponse()
        return r.status, r.read().decode("utf-8", "replace")
    finally:
        conn.close()


class DropRecorder(threading.Thread):
    """Every version of one file: reads it every ``period_s`` and keeps
    each text that differs from the last (a file's identity by inode,
    mtime and size can repeat across an atomic rewrite)."""

    def __init__(self, path: str, period_s: float = 0.02) -> None:
        super().__init__(name="drop-recorder", daemon=True)
        self.path, self.period_s = path, period_s
        self.versions: List[Dict] = []
        self.stop = threading.Event()

    def run(self) -> None:
        last = None
        while not self.stop.wait(self.period_s):
            try:
                with open(self.path) as f:
                    text = f.read()
            except FileNotFoundError:
                continue
            if text != last:
                last = text
                self.versions.append({"t": time.monotonic(), "text": text})


def alter(body: str, drop: List[Dict], own=frozenset()) -> str:
    """``body`` with one per-card sample (``tpu_*``) that a drop file
    version carries, and that the node does not serve itself (``own``:
    its own series, which win over the drop file's), given another value
    (a planted fault)."""

    lines = {ln for v in list(drop) for ln in v["text"].splitlines()}
    out = body.splitlines()
    for i, line in enumerate(out):
        got = parse_line(line)
        if line in lines and line.startswith("tpu_") and got is not None \
                and got[:2] not in own:
            name, _, value = line.rpartition(" ")
            out[i] = f"{name} {float(value) + 1.0!r}"
            break
    return "\n".join(out) + "\n"


def silent(body: str) -> str:
    """``body`` without any of the card's families (``tpu_*``): a node
    that serves nothing of the card (a planted fault)."""

    return "".join(ln + "\n" for ln in body.splitlines()
                   if not ln.startswith("tpu_"))


def scraper(cfg: Dict, t0: float, index: int, out: List[Dict],
            drop: List[Dict]) -> None:
    """One client's open loop of scrapes."""

    hz = cfg["hz"]
    own = {(fam, tuple(map(tuple, labels)))
           for fam, labels in cfg.get("own", ())}
    rng = random.Random(f"{cfg['seed']}:{index}")
    k = 0
    while True:
        due = t0 + (k + rng.random()) / hz
        if k >= cfg["seconds"] * hz:
            return
        delay = due - time.monotonic()
        if delay > 0:
            time.sleep(delay)
        rec = {"client": index, "due": due, "sent": time.monotonic()}
        try:
            status, body = get(cfg["port"], cfg["path"], cfg["timeout_s"])
            rec["end"] = time.monotonic()
            rec["status"] = status
            fault = cfg.get("fault")
            rec["body"] = alter(body, drop, own) if fault == "altered" else \
                silent(body) if fault == "silent" else body
            rec["ok"] = status == 200 and \
                rec["end"] - due <= cfg["timeout_s"]
        except OSError as e:
            rec["end"] = time.monotonic()
            rec["error"] = repr(e)
            rec["ok"] = False
        out.append(rec)
        k += 1


def run(cfg: Dict, go_line: str, drop: List[Dict]) -> Dict:
    t0 = float(go_line.split()[1])
    pids = cfg["pids"]
    cpu0 = {name: proc_cpu_s(pid) for name, pid in pids.items()}
    c0 = time.monotonic()
    records: List[Dict] = []
    threads = [threading.Thread(target=scraper,
                                args=(cfg, t0, i, records, drop),
                                name=f"scraper-{i}", daemon=True)
               for i in range(cfg["scrapers"])]
    for t in threads:
        t.start()
    # the sandbox's /proc has no VmHWM: the peak is VmRSS sampled at
    # RSS_HZ over the window
    rss = {name: proc_rss_kib(pid) for name, pid in pids.items()}
    while time.monotonic() < t0 + cfg["seconds"]:
        time.sleep(min(1.0 / RSS_HZ,
                       max(0.0, t0 + cfg["seconds"] - time.monotonic())))
        for name, pid in pids.items():
            rss[name] = max(rss[name], proc_rss_kib(pid))
    cpu1 = {name: proc_cpu_s(pid) for name, pid in pids.items()}
    c1 = time.monotonic()
    for t in threads:
        t.join(cfg["timeout_s"] + 5.0)
    return {"t0": t0, "cpu_window": [c0, c1],
            "cpu_s": {n: cpu1[n] - cpu0[n] for n in pids},
            "rss_peak_kib": rss, "records": sorted(records,
                                              key=lambda r: r["due"])}


def main() -> int:
    cfg = json.loads(sys.stdin.readline())
    rec = DropRecorder(cfg["drop"])
    rec.start()
    go = sys.stdin.readline()
    out = {"refused_modules": []}
    if go.startswith("go "):
        out.update(run(cfg, go, rec.versions))
    rec.stop.set()
    rec.join(5.0)
    out["drops"] = rec.versions
    out["refused_modules"] = sorted(
        {m.split(".")[0] for m in sys.modules} & set(REFUSED))
    with open(cfg["out"], "w") as f:
        json.dump(out, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
