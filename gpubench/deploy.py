"""A configuration's monitor processes, started as its manifest runs them.

The configuration file lists its processes with their argv; placeholders
are filled per run: ``{python}`` this interpreter, ``{native:NAME}`` the
program's native build of NAME, ``{port}`` a free local port (one per
run, the scrape endpoint's), ``{drop}`` the workload's drop directory,
``{run}`` the run's directory under ``TMPDIR`` (also every process's
working directory, so a unix socket can be named relatively whatever
the directory's length), ``{node}`` the host's name.  Python processes
run under the import guard (``guard/sitecustomize.py``).
"""

from __future__ import annotations

import http.client
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
#: how long the node is read before the drop file may appear
SETTLE_S = 3.0


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def http_status(port: int, path: str, timeout: float = 2.0) -> Optional[int]:
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request("GET", path)
        r = conn.getresponse()
        r.read()
        return r.status
    except OSError:
        return None
    finally:
        conn.close()


def http_body(port: int, path: str, timeout: float = 10.0) -> str:
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request("GET", path)
        return conn.getresponse().read().decode("utf-8", "replace")
    finally:
        conn.close()


class OwnSeries(threading.Thread):
    """The series a node serves of itself: the union of its scrapes
    until the workload's drop file exists.  A body whose response ends
    after the file appeared is left out: a sweep may have merged it."""

    def __init__(self, port: int, path: str, drop: str,
                 period_s: float = 0.25) -> None:
        super().__init__(name="own-series", daemon=True)
        self.port, self.path, self.drop = port, path, drop
        self.period_s = period_s
        self.series: set = set()
        self.bodies = 0
        self.t_first: Optional[float] = None
        self.stop = threading.Event()
        self.settled = threading.Event()

    def run(self) -> None:
        from .reference.promtext import samples

        while not self.stop.is_set() and not os.path.exists(self.drop):
            try:
                body = http_body(self.port, self.path)
            except OSError:
                body = None
            if body is not None and not os.path.exists(self.drop):
                self.series |= set(samples(body))
                self.bodies += 1
                if self.t_first is None:
                    self.t_first = time.monotonic()
                if time.monotonic() - self.t_first >= SETTLE_S:
                    self.settled.set()
            self.stop.wait(self.period_s)
        self.settled.set()

    def wait(self, timeout_s: float = 60.0) -> None:
        """Until the node has been read for SETTLE_S: some of its own
        series appear only from its second sweep or its first scrape
        on."""

        self.settled.wait(timeout_s)


def guarded_env(base: Dict[str, str], log_path: str) -> Dict[str, str]:
    """``base`` with the import guard and this checkout first on the
    Python path, and the guard's log."""

    env = dict(base)
    path = [str(HERE / "guard"), str(ROOT)]
    if env.get("PYTHONPATH"):
        path.append(env["PYTHONPATH"])
    env["PYTHONPATH"] = os.pathsep.join(path)
    env["GPUBENCH_IMPORT_LOG"] = log_path
    return env


class Node:
    """The monitor processes of one configuration on this machine."""

    def __init__(self, config: Dict, run_dir: str, drop_dir: str,
                 uuid: str, native: Dict[str, str]) -> None:
        self.config = config
        self.run_dir, self.drop_dir = run_dir, drop_dir
        self.port = free_port()
        self.guard_log = os.path.join(run_dir, "refused-imports.log")
        open(self.guard_log, "w").close()
        self.subst = {"{python}": sys.executable, "{port}": str(self.port),
                      "{drop}": drop_dir, "{run}": run_dir,
                      "{node}": os.uname().nodename}
        self.subst.update({"{native:%s}" % k: str(v)
                           for k, v in native.items()})
        with open(os.path.join(run_dir, "pods.json"), "w") as f:
            json.dump({uuid: config.get("pod", {})}, f)
        self.procs: Dict[str, subprocess.Popen] = {}
        self.logs: Dict[str, str] = {}
        self.t_start = 0.0
        self.ready_s: Dict[str, float] = {}

    def _fill(self, arg: str) -> str:
        for k, v in self.subst.items():
            arg = arg.replace(k, v)
        return arg

    def start(self) -> None:
        base = dict(os.environ)
        base.update({k: self._fill(v)
                     for k, v in self.config.get("env", {}).items()})
        self.t_start = time.monotonic()
        for p in self.config["processes"]:
            argv = [self._fill(a) for a in p["argv"]]
            env = dict(base)
            env.update({k: self._fill(v) for k, v in p.get("env", {}).items()})
            if argv[0] == sys.executable:
                env = guarded_env(env, self.guard_log)
            log = os.path.join(self.run_dir, f"{p['name']}.err")
            self.logs[p["name"]] = log
            with open(log, "w") as err:
                self.procs[p["name"]] = subprocess.Popen(
                    argv, cwd=self.run_dir, env=env,
                    stdout=subprocess.DEVNULL, stderr=err,
                    start_new_session=True)

    def wait_ready(self, timeout_s: float = 120.0) -> None:
        """Wait for each process's readiness (``ready``: a file it makes,
        or an HTTP path on the run's port answering 200), in order;
        records the seconds from the start to each."""

        deadline = time.monotonic() + timeout_s
        for p in self.config["processes"]:
            ready = p.get("ready", {})
            proc = self.procs[p["name"]]
            while True:
                if proc.poll() is not None:
                    raise RuntimeError(f"{p['name']} exited {proc.returncode}:"
                                       f" {self.tail(p['name'])}")
                if "file" in ready and os.path.exists(
                        os.path.join(self.run_dir, ready["file"])):
                    break
                if "http" in ready and http_status(self.port,
                                                   ready["http"]) == 200:
                    break
                if not ready:
                    break
                if time.monotonic() > deadline:
                    raise RuntimeError(
                        f"{p['name']} not ready in {timeout_s} s: "
                        f"{self.tail(p['name'])}")
                time.sleep(0.05)
            self.ready_s[p["name"]] = time.monotonic() - self.t_start

    def tail(self, name: str, n: int = 1500) -> str:
        try:
            with open(self.logs[name]) as f:
                return f.read()[-n:]
        except OSError:
            return ""

    def pids(self) -> Dict[str, int]:
        return {name: p.pid for name, p in self.procs.items()}

    def alive(self) -> List[str]:
        return [n for n, p in self.procs.items() if p.poll() is None]

    def refused_imports(self) -> List[str]:
        with open(self.guard_log) as f:
            return sorted({ln.split()[1] for ln in f if ln.strip()})

    def stop(self) -> Dict[str, Optional[int]]:
        """SIGTERM every process (in reverse order), reap each, kill what
        outlives 10 s; their exit codes."""

        codes: Dict[str, Optional[int]] = {}
        for name in reversed(list(self.procs)):
            p = self.procs[name]
            if p.poll() is None:
                p.send_signal(signal.SIGTERM)
                try:
                    p.wait(timeout=10.0)
                except subprocess.TimeoutExpired:
                    os.killpg(p.pid, signal.SIGKILL)
                    p.wait()
            codes[name] = p.returncode
        return codes
