"""``gpu-hostengine`` under ThreadSanitizer and AddressSanitizer (opt-in:
``TPUMON_RUN_SANITIZERS=1``).

The port's twin of the JAX package's daemon matrix
(``tests/test_sanitizers.py``): the port's native agent, built from
``tpumon_torch/native/`` with ``-fsanitize=thread`` or ``-fsanitize=address``
beside its normal flags, serves the fake NVML
(``tpumon_torch/testlib/fake_nvml.c``, built with the same sanitizer)
while every concurrent surface runs at once — binary ``sweep_frame``
clients, JSON ``read_fields_bulk`` clients, watches and burst-derived
reads (the 100 Hz burst loop live), ``/metrics`` scrapes, Xid lines
appended to the kernel log it tails, and a drop file rewritten
non-atomically under the merge.  Any report fails the test, through the
sanitizer's exit code or its text on stderr.

Opt-in because the sanitized builds and the hammering take about a
minute; the codec and poll engine's TSan drivers are the opt-in cases of
``tests/test_torch_codec_native.py`` and ``test_torch_fleet_native.py``.
"""

from __future__ import annotations

import os
import re
import subprocess
import threading
import time
import urllib.request

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTLIB = os.path.join(REPO, "tpumon_torch", "testlib")

pytestmark = pytest.mark.skipif(
    "TPUMON_RUN_SANITIZERS" not in os.environ,
    reason="sanitizer runs are opt-in (TPUMON_RUN_SANITIZERS=1)")

#: burst-derived ids read by the JSON clients: power's 1 s min and
#: integral (``2000 + 155 * 4 + agg``) — every read harvests the burst
#: cells while the inner loop folds into them
BURST_READS = (2620, 2623)


def _agent(flag: str) -> str:
    from tpumon_torch import _build

    t = _build.NATIVE_TARGETS["gpu-hostengine"]
    # GCC's diagnostics under each sanitizer, kept as warnings: TSan does
    # not model the burst sampler's standalone fence (the seqlock
    # reader's fence before its relaxed recheck; the cells' words are
    # std::atomic, so TSan still sees every access), and ASan's
    # instrumentation makes GCC 12 see maybe-uninitialized members
    # inside libstdc++'s std::regex
    extra = {"thread": ("-Wno-error=tsan",),
             "address": ("-Wno-error=maybe-uninitialized",)}[flag]
    san = _build.NativeTarget(f"gpu-hostengine-{flag}", True, t.main,
                              t.deps, (f"-fsanitize={flag}",) + extra
                              + t.link)
    return str(_build._compile_native(san, None))


def _fake_nvml(tmp: str, flag: str) -> str:
    out = os.path.join(tmp, f"libfake_nvml_{flag}.so")
    subprocess.run(["cc", "-shared", "-fPIC", f"-fsanitize={flag}", "-I",
                    TESTLIB, "-o", out, os.path.join(TESTLIB, "fake_nvml.c"),
                    "-lpthread"], check=True, capture_output=True,
                   timeout=120)
    return out


def _hammer(agent: str, nvml: str, tmp: str, env: dict) -> str:
    """Drive every concurrent surface of the agent at once; returns its
    stderr."""

    from tpumon_torch.backends.agent import AgentBackend

    sock = os.path.join(tmp, "san.sock")
    kmsg = os.path.join(tmp, "kmsg")
    open(kmsg, "w").close()
    dropdir = os.path.join(tmp, "drop")
    os.makedirs(dropdir)
    err_path = os.path.join(tmp, "stderr.txt")
    env = dict(env, TPUMON_NVML_PATH=nvml, FAKE_NVML_XIDS="1:79,0:48")
    with open(err_path, "w") as ef:
        proc = subprocess.Popen(
            [agent, "--domain-socket", sock, "--prom-port", "0",
             "--kmsg", kmsg, "--burst-hz", "100",
             "--merge-textfile", os.path.join(dropdir, "*.prom")],
            stdout=subprocess.DEVNULL, stderr=ef, env=env)

    def client() -> AgentBackend:
        b = AgentBackend(address=f"unix:{sock}", timeout_s=20.0,
                         connect_retry_s=30.0)
        b.open()
        return b

    try:
        first = client()
        port = None
        deadline = time.monotonic() + 30
        while port is None and time.monotonic() < deadline:
            m = re.search(r"port (\d+)", open(err_path).read())
            port = int(m.group(1)) if m else None
            time.sleep(0.05)
        assert port, open(err_path).read()[-2000:]
        chips = first.chip_count()
        assert chips >= 1
        reqs = [(c, [150, 155, 203, 252, 460]) for c in range(chips)]
        stop = threading.Event()
        errors = []
        counts = {"binary": 0, "json": 0, "scrape": 0}

        def guarded(fn):
            def run():
                try:
                    fn()
                except Exception as e:  # surfaced after the join
                    errors.append(e)
            return run

        @guarded
        def binary_sweeps():
            c = client()
            seq = 0
            while not stop.is_set():
                _, events = c.sweep_fields_bulk(reqs, events_since=seq)
                if events:
                    seq = max(e.seq for e in events)
                counts["binary"] += 1
            c.close()

        @guarded
        def json_sweeps():
            c = client()
            c.ensure_watch([155, 203, 250], freq_us=20_000, keep_age_s=5.0)
            while not stop.is_set():
                c._call("read_fields_bulk",
                        reqs=[{"index": i, "fields": f} for i, f in reqs],
                        events_since=0)
                c.read_fields(0, [155, *BURST_READS])
                c.agent_latest(min(1, chips - 1), [203])
                c.poll_events(0)
                counts["json"] += 1
            c.close()

        @guarded
        def scrapes():
            while not stop.is_set():
                urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                       timeout=20).read()
                counts["scrape"] += 1

        @guarded
        def kmsg_lines():
            seq = 0
            while not stop.is_set():
                seq += 1
                with open(kmsg, "a") as f:
                    f.write(f"3,{seq},{seq},-;NVRM: Xid (PCI:0000:18:00): "
                            f"79, pid=1, GPU has fallen off the bus.\n")
                time.sleep(0.01)

        @guarded
        def drop_file():
            # rewritten non-atomically while scrapes merge it: the merge
            # rides out torn content and file churn
            i = 0
            path = os.path.join(dropdir, "wl.prom")
            while not stop.is_set():
                i += 1
                with open(path, "w") as f:
                    f.write("# HELP tpu_workload_x test\n"
                            "# TYPE tpu_workload_x gauge\n"
                            f'tpu_workload_x{{i="{i}"}} {i}\n')
                    if i % 3 == 0:
                        f.write("torn_li")
                if i % 5 == 0:
                    os.unlink(path)
                time.sleep(0.005)

        threads = [threading.Thread(target=t) for t in
                   (binary_sweeps, binary_sweeps, json_sweeps, json_sweeps,
                    scrapes, scrapes, kmsg_lines, drop_file)]
        for t in threads:
            t.start()
        time.sleep(8.0)
        stop.set()
        for t in threads:
            t.join(timeout=60)
        assert not errors, errors
        assert min(counts.values()) > 0, counts
        first.close()
    finally:
        proc.terminate()
        rc = proc.wait(timeout=60)
        assert rc in (0, -15), (f"sanitizer flagged exit {rc}: "
                                f"{open(err_path).read()[-3000:]}")
    text = open(err_path).read()
    assert "WARNING: ThreadSanitizer" not in text, text[-3000:]
    assert "ERROR: AddressSanitizer" not in text, text[-3000:]
    return text


def test_gpu_hostengine_under_tsan(tmp_path):
    env = dict(os.environ, TSAN_OPTIONS="halt_on_error=0 exitcode=66")
    _hammer(_agent("thread"), _fake_nvml(str(tmp_path), "thread"),
            str(tmp_path), env)


def test_gpu_hostengine_under_asan(tmp_path):
    env = dict(os.environ,
               ASAN_OPTIONS="detect_leaks=0 abort_on_error=0 exitcode=67")
    _hammer(_agent("address"), _fake_nvml(str(tmp_path), "address"),
            str(tmp_path), env)
