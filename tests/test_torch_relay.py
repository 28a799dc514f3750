"""The port's stream relay tree (``tpumon_torch/relay.py``) against the
reference's (``tpumon/relay.py``), on seeded streams.

The reference's nine cases, run on the port: a leaf subscriber's decoded
snapshot equals the origin's published snapshot exactly (repr: values
and types) across mid-run attach, relay restart (the resync keyframe), an
upstream loss (stale heartbeats), a flapping upstream (the breaker's park
and unpark), an attach storm, a wedged CLI relay and the CLI end to end
with ``--metrics-port``.  The first case also runs the reference's relay
tree on the same origin: the port's leaf receives the same bytes as the
reference's leaf, keyframe included (exact).
"""

import os
import random
import signal
import socket
import subprocess
import sys
import tempfile
import time

import pytest

from tpumon import relay as ref_relay
from tpumon_torch.frameserver import FrameServer, StreamDecoder, StreamHub
from tpumon_torch.relay import (DEGRADED, LIVE, PARKED, RelayTree,
                                StreamRelay, relay_metric_lines)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# -- helpers -------------------------------------------------------------------


def make_origin(tmp=None):
    server = FrameServer()
    hub = StreamHub(server)
    addr = server.add_unix_listener(hub)
    pub = hub.publisher("")
    server.start()
    return server, hub, addr, pub


def attach(addr, stream="", timeout=0.5):
    if addr.startswith("unix:"):
        sk = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        sk.connect(addr[5:])
    else:
        host, _, port = addr.rpartition(":")
        sk = socket.create_connection((host, int(port)))
    sk.sendall(b'{"op": "stream", "stream": "' + stream.encode()
               + b'"}\n')
    sk.settimeout(timeout)
    return sk


def drain(sk, dec, seconds, raw=None):
    out = []
    end = time.monotonic() + seconds
    while time.monotonic() < end:
        try:
            data = sk.recv(65536)
        except socket.timeout:
            continue
        if not data:
            break
        if raw is not None:
            raw += data
        out.extend(dec.feed(data))
    return out


def wait_until(cond, timeout=10.0, interval=0.01, what="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(interval)
    raise AssertionError(f"timed out waiting for {what}")


def norm(snap):
    """Chip-order-normalized repr: a decoder mirror's chip order
    carries the stream's delete/re-add history, a freshly-built
    expectation dict does not — values and types still compare
    exactly.  (The strict byte-order differential is
    test_leaf_byte_identical_through_tree_with_midrun_attach, where
    the expectation shares the mirror's history.)"""

    return repr({c: snap[c] for c in sorted(snap)})


def churny_schedule(rng, chips, fields, ticks):
    """Randomized churn/blank/chip-loss value schedule: yields the
    full chips dict per tick (the sweep-pipeline snapshot contract:
    the publisher holds it read-only, so each tick builds new dicts)."""

    values = {c: {f: rng.random() for f in range(fields)}
              for c in range(chips)}
    for _ in range(ticks):
        values = {c: dict(vals) for c, vals in values.items()}
        for _ in range(rng.randrange(1, 12)):
            roll = rng.random()
            c = rng.randrange(chips)
            if roll < 0.05 and len(values) > 1 and c in values:
                del values[c]                      # chip loss
            elif roll < 0.10 and c not in values:
                values[c] = {f: rng.random()       # chip reappears
                             for f in range(fields)}
            elif c in values:
                f = rng.randrange(fields)
                values[c][f] = rng.choice([
                    rng.random(), rng.randrange(10_000), None,  # blank
                    f"s{rng.randrange(100)}",
                    [rng.random(), rng.random()]])
        yield values


# -- the differential ----------------------------------------------------------


def test_leaf_byte_identical_through_tree_with_midrun_attach():
    """Every decoded leaf tick equals the origin snapshot published
    at that timestamp (repr — types included) through a depth-2 tree,
    for a subscriber attached from the start AND one attached
    mid-run, under a randomized churn/blank/chip-loss schedule."""

    server, hub, addr, pub = make_origin()
    kw = dict(depth=2, fanout=2, backoff_base_s=0.1,
              stale_tick_interval_s=0.5, stale_after_s=30.0)
    tree = RelayTree(addr, "", **kw)
    ref_tree = ref_relay.RelayTree(addr, "", **kw)
    early = attach(tree.leaf_addresses()[0])
    ref_early = attach(ref_tree.leaf_addresses()[0])
    early_dec, ref_dec = StreamDecoder(), StreamDecoder()
    late = late_dec = None
    published = {}
    try:
        # both leaves attached (header + empty keyframe) before the run
        wait_until(lambda: all(r.publisher.subscribers == 1
                               for r in tree.leaves()[:1]
                               + ref_tree.leaves()[:1]), what="attach")
        rng = random.Random(0x1EAF)
        for i, values in enumerate(churny_schedule(rng, 6, 8, 40)):
            ts = 1000.0 + i
            published[ts] = repr(values)
            pub.publish(values, now=ts)
            if i == 19:
                late = attach(tree.leaf_addresses()[1])
                late_dec = StreamDecoder()
            time.sleep(0.005)
        raw, ref_raw = bytearray(), bytearray()
        for sk, dec, name, buf in ((early, early_dec, "early", raw),
                                   (late, late_dec, "late", None),
                                   (ref_early, ref_dec, "reference", ref_raw)):
            ticks = [t for t in drain(sk, dec, 2.0, buf) if not t.stale]
            assert ticks, f"{name}: no ticks decoded"
            for t in ticks:
                assert t.timestamp in published, (name, t.timestamp)
                assert repr(t.snapshot) == published[t.timestamp], (
                    f"{name}: leaf snapshot diverged at "
                    f"{t.timestamp}")
            # the late attach joined mid-run on a keyframe and must
            # have seen the tail of the run
            assert ticks[-1].timestamp == 1039.0, name
        # the port's leaf bytes are the reference's, header included
        assert bytes(raw) == bytes(ref_raw)
    finally:
        for sk in (early, late, ref_early):
            if sk is not None:
                sk.close()
        tree.close()
        ref_tree.close()
        server.close()


def test_relay_restart_resyncs_subtree_siblings_untouched():
    """Restarting a mid-tier relay on the same socket path: its
    subtree sees stale heartbeats then a keyframe resync and
    converges; the SIBLING subtree (fed by the other level-1 relay)
    sees zero extra keyframes and no staleness."""

    server, hub, addr, pub = make_origin()
    sockdir = tempfile.mkdtemp(prefix="tpumon-relaytest-")
    path = os.path.join(sockdir, "mid.sock")
    mid = StreamRelay(addr, "", listen_unix=path, backoff_base_s=0.05,
                      backoff_max_s=0.2, stale_tick_interval_s=0.1,
                      stale_after_s=30.0)
    mid.start()
    sibling = StreamRelay(addr, "", backoff_base_s=0.05,
                          stale_tick_interval_s=0.1,
                          stale_after_s=30.0)
    sibling.start()
    # children: one leaf relay under mid (the "subtree"), one direct
    # subscriber under sibling
    leaf = StreamRelay(f"unix:{path}", "", backoff_base_s=0.05,
                       backoff_max_s=0.2, stale_tick_interval_s=0.1,
                       stale_after_s=30.0)
    leaf.start()
    sub = attach(leaf.address)
    sub_dec = StreamDecoder()
    sib = attach(sibling.address)
    sib_dec = StreamDecoder()
    try:
        last = None
        for i, values in enumerate(churny_schedule(
                random.Random(7), 4, 6, 10)):
            pub.publish(values, now=2000.0 + i)
            last = values
            time.sleep(0.01)
        wait_until(lambda: any(
            t.timestamp == 2009.0 for t in drain(sub, sub_dec, 0.2)),
            what="subtree warm")
        drain(sib, sib_dec, 0.2)
        sib_kf_before = sib_dec.keyframes

        # restart the mid-tier relay: subtree dark, then resynced
        mid.close()
        darks = list(churny_schedule(random.Random(8), 4, 6, 5))
        for i, values in enumerate(darks):
            pub.publish(values, now=3000.0 + i)
            last = values
            time.sleep(0.01)
        stale = [t for t in drain(sub, sub_dec, 0.5) if t.stale]
        assert stale, "subtree never surfaced staleness"
        # last-known state survives at the leaf while dark
        assert stale[-1].timestamp == 2009.0

        mid2 = StreamRelay(addr, "", listen_unix=path,
                           backoff_base_s=0.05, backoff_max_s=0.2,
                           stale_tick_interval_s=0.1,
                           stale_after_s=30.0)
        mid2.start()
        try:
            # leaf reconnects to the SAME path; the fresh keyframe
            # cascades and the subtree converges on current state
            wait_until(lambda: repr(
                (lambda ts: ts[-1].snapshot if ts else None)(
                    [t for t in drain(sub, sub_dec, 0.2)
                     if not t.stale])) == repr(last),
                timeout=15.0, what="subtree resync")
            # one more publish proves the delta stream continues
            nxt = {c: {f: float(c * 100 + f) for f in range(6)}
                   for c in range(4)}
            pub.publish(nxt, now=4000.0)
            wait_until(lambda: any(
                t.timestamp == 4000.0 and norm(t.snapshot) == norm(nxt)
                for t in drain(sub, sub_dec, 0.2)),
                what="post-resync delta")
        finally:
            mid2.close()
        # sibling subtree: the same run, not one extra keyframe and
        # never a stale tick
        sib_ticks = drain(sib, sib_dec, 0.5)
        assert sib_dec.keyframes == sib_kf_before
        assert not any(t.stale for t in sib_ticks)
        assert norm([t for t in sib_ticks
                     if not t.stale][-1].snapshot) == norm(nxt)
    finally:
        sub.close()
        sib.close()
        leaf.close()
        sibling.close()
        mid.close()
        server.close()


def test_degraded_staleness_heartbeats_and_attach_while_down():
    """Upstream loss: stale heartbeats carry the last-known snapshot
    and its timestamp; a subscriber attaching DURING the outage still
    gets a keyframe (stale-flagged) from the mirror; stats surface
    the degradation."""

    server, hub, addr, pub = make_origin()
    relay = StreamRelay(addr, "", backoff_base_s=5.0,
                        backoff_max_s=5.0, stale_tick_interval_s=0.1,
                        stale_after_s=30.0)
    relay.start()
    sk = attach(relay.address)
    dec = StreamDecoder()
    try:
        pub.publish({0: {1: 42, 2: "x"}}, now=500.0)
        wait_until(lambda: any(t.timestamp == 500.0
                               for t in drain(sk, dec, 0.2)),
                   what="first tick")
        server.kill_connections(addr)
        wait_until(lambda: relay.state == DEGRADED, what="degraded")
        hb = [t for t in drain(sk, dec, 0.4) if t.stale]
        assert hb, "no stale heartbeats"
        assert all(t.timestamp == 500.0 for t in hb)
        assert all(repr(t.snapshot) == repr({0: {1: 42, 2: "x"}})
                   for t in hb)
        # attach while degraded: keyframe from the mirror, stale flag
        sk2 = attach(relay.address)
        dec2 = StreamDecoder()
        try:
            items = drain(sk2, dec2, 0.4)
            assert items and items[0].keyframe and items[0].stale
            assert repr(items[0].snapshot) == repr({0: {1: 42, 2: "x"}})
        finally:
            sk2.close()
        st = relay.stats()
        assert st["up"] == 0.0
        assert st["stale_seconds"] > 0.0
        assert st["heartbeats_total"] >= 1
        # metric lines render the degradation
        text = "\n".join(relay_metric_lines(relay))
        assert "tpumon_relay_up{" in text
        assert "tpumon_relay_stale_seconds" in text
    finally:
        sk.close()
        relay.close()
        server.close()


def test_silent_upstream_flagged_stale_before_first_frame():
    """An upstream that accepts the attach but never publishes a
    frame must not look healthy forever: after the grace the relay
    heartbeats (empty-snapshot stale ticks — self-contained even for
    a subscriber that never got a keyframe) and stats() reports the
    staleness while up stays 1 (the connection IS alive)."""

    server, hub, addr, pub = make_origin()   # publisher never publishes
    relay = StreamRelay(addr, "", stale_tick_interval_s=0.1,
                        stale_after_s=0.3)
    relay.start()
    sk = attach(relay.address)
    dec = StreamDecoder()
    try:
        wait_until(lambda: relay.state == LIVE, what="relay live")
        hb = [t for t in drain(sk, dec, 1.2) if t.stale]
        assert hb, "silent upstream never surfaced staleness"
        assert all(t.snapshot == {} for t in hb)
        st = relay.stats()
        assert st["up"] == 1.0
        assert st["stale_seconds"] > 0.0
    finally:
        sk.close()
        relay.close()
        server.close()


def test_circuit_breaker_parks_flapping_upstream_and_unparks():
    """A flapping upstream (connects that keep dying) opens the
    breaker: the relay parks, keeps serving its mirror, and unpark()
    resumes reconnection."""

    server, hub, addr, pub = make_origin()
    relay = StreamRelay(addr, "", backoff_base_s=0.02,
                        backoff_max_s=0.05, reconnect_budget=3,
                        budget_window_s=60.0,
                        stale_tick_interval_s=0.1, stale_after_s=30.0)
    relay.start()
    try:
        pub.publish({0: {1: 7}}, now=600.0)
        wait_until(lambda: relay.state == LIVE, what="live")
        # flap: kill every upstream connection as it lands
        for _ in range(10):
            if relay.parked:
                break
            server.kill_connections(addr)
            time.sleep(0.05)
        wait_until(lambda: relay.state == PARKED, what="parked")
        assert relay.stats()["parked"] == 1.0
        # parked relay still serves the mirror to a fresh attach
        sk = attach(relay.address)
        dec = StreamDecoder()
        try:
            items = drain(sk, dec, 0.4)
            assert items and items[0].stale
            assert repr(items[0].snapshot) == repr({0: {1: 7}})
        finally:
            sk.close()
        relay.unpark()
        wait_until(lambda: relay.state == LIVE, what="unparked+live")
    finally:
        relay.close()
        server.close()


def test_attach_storm_never_touches_origin():
    """1k-style attach storm at a relay (scaled down): ZERO origin
    keyframe encodes, zero origin byte growth; every storm subscriber
    is served a keyframe synthesized from the relay's mirror."""

    server, hub, addr, pub = make_origin()
    relay = StreamRelay(addr, "", stale_tick_interval_s=1.0,
                        stale_after_s=60.0)
    relay.start()
    socks = []
    try:
        pub.publish({c: {f: float(f) for f in range(8)}
                     for c in range(8)}, now=700.0)
        wait_until(lambda: relay.upstream_ticks_total >= 1,
                   what="relay warm")
        kf0 = pub.keyframes_total
        bytes0 = pub.bytes_sent_total
        for _ in range(100):
            socks.append(attach(relay.address))
        wait_until(lambda: relay.publisher.keyframes_total >= 100,
                   what="storm keyframes")
        assert pub.keyframes_total == kf0
        assert pub.bytes_sent_total == bytes0
        assert pub.subscribers == 1       # the relay, only ever
    finally:
        for s in socks:
            s.close()
        relay.close()
        server.close()


# -- process-level faults (the CLI is the unit) --------------------------------


def _spawn_cli_relay(upstream, path, logf, extra=()):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    argv = [sys.executable, "-m", "tpumon_torch.cli.relay",
            "--connect", upstream, "--stream", "",
            "--listen-unix", path, "--backoff-base", "0.1",
            "--backoff-max", "0.3", "--stale-tick-interval", "0.1",
            "--stale-after", "0.5", "--timeout", "2"] + list(extra)
    with open(logf, "ab") as lf:
        return subprocess.Popen(argv, stdin=subprocess.DEVNULL,
                                stdout=lf, stderr=lf, env=env,
                                start_new_session=True)


def test_wedged_cli_relay_recovered_by_parent_backpressure(tmp_path):
    """SIGSTOP a real tpumon-relay child (the wedged-relay leg): the
    ORIGIN's ordinary subscriber backpressure marks it stale and
    drops frames (bounded buffer, siblings unaffected); on SIGCONT it
    drains, is resynced by an ordinary keyframe, and its subscriber
    converges byte-identically."""

    server = FrameServer()
    hub = StreamHub(server)
    addr = server.add_unix_listener(hub)
    # small buffer so the wedge overflows within a few churny ticks
    pub = hub.publisher("", max_buffer_bytes=4096)
    server.start()
    path = str(tmp_path / "relay.sock")
    proc = _spawn_cli_relay(addr, path, str(tmp_path / "relay.log"))
    sk = None
    try:
        wait_until(lambda: os.path.exists(path), what="relay bind")
        pub.publish({c: {f: float(f) for f in range(16)}
                     for c in range(16)}, now=800.0)
        sk = attach(f"unix:{path}")
        dec = StreamDecoder()
        wait_until(lambda: any(t.timestamp == 800.0
                               for t in drain(sk, dec, 0.2)),
                   what="leaf warm")
        os.kill(proc.pid, signal.SIGSTOP)
        last = None
        overflowed = False
        for i in range(200):
            last = {c: {f: random.random() for f in range(16)}
                    for c in range(16)}
            pub.publish(last, now=900.0 + i)
            if pub.overflows_total >= 1:
                overflowed = True
                break
            time.sleep(0.005)
        assert overflowed, "wedged relay never overflowed its bound"
        dropped = pub.dropped_frames_total
        assert dropped >= 1
        os.kill(proc.pid, signal.SIGCONT)
        # the drain triggers an ordinary drop-to-keyframe resync; the
        # keyframe cascades through the relay to its subscriber
        final = {c: {f: float(c * 100 + f) for f in range(16)}
                 for c in range(16)}

        def converged():
            pub.publish(final, now=2000.0)
            ticks = [t for t in drain(sk, dec, 0.2) if not t.stale]
            return ticks and repr(ticks[-1].snapshot) == repr(final)

        wait_until(converged, timeout=15.0, what="post-wedge resync")
        assert pub.resyncs_total >= 1
    finally:
        if sk is not None:
            sk.close()
        if proc.poll() is None:
            os.kill(proc.pid, signal.SIGCONT)
            proc.kill()
            proc.wait(timeout=10)
        server.close()


def test_cli_relay_e2e_with_metrics_and_stream_cli(tmp_path):
    """tpumon-relay as a real process: serves the relayed stream to
    the tpumon-stream CLI (JSON format), and --metrics-port exposes
    tpumon_relay_up / stream gauges."""

    import json as _json
    import urllib.request

    server = FrameServer()
    hub = StreamHub(server)
    addr = server.add_unix_listener(hub)
    pub = hub.publisher("")
    server.start()
    path = str(tmp_path / "relay.sock")
    proc = _spawn_cli_relay(addr, path, str(tmp_path / "relay.log"),
                            extra=["--metrics-port", "0"])
    # port 0 is kernel-assigned and unknowable: use a fixed free port
    proc.kill()
    proc.wait(timeout=10)
    import socket as _s
    probe = _s.socket()
    probe.bind(("127.0.0.1", 0))
    port = probe.getsockname()[1]
    probe.close()
    proc = _spawn_cli_relay(addr, path, str(tmp_path / "relay.log"),
                            extra=["--metrics-port", str(port)])
    reader = None
    try:
        wait_until(lambda: os.path.exists(path), what="relay bind")
        pub.publish({0: {1: 11.5}}, now=900.0)
        env = dict(os.environ)
        env["PYTHONPATH"] = REPO + os.pathsep + env.get(
            "PYTHONPATH", "")
        reader = subprocess.Popen(
            [sys.executable, "-m", "tpumon_torch.cli.stream",
             "--connect", f"unix:{path}", "--format", "json",
             "-c", "2"],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env)
        # --count counts REAL frames (stale heartbeats repeat known
        # state and do not satisfy it): keep publishing until the
        # reader has its 2 — the attach keyframe plus a live delta
        for i in range(100):
            if reader.poll() is not None:
                break
            pub.publish({0: {1: 12.5 + i}}, now=901.0 + i)
            time.sleep(0.1)
        out, err = reader.communicate(timeout=10)
        assert reader.returncode == 0, err
        lines = [_json.loads(ln) for ln in out.splitlines()]
        real = [ln for ln in lines if not ln.get("stale")]
        assert [ln["kind"] for ln in real] == ["tick", "tick"]
        assert real[0]["keyframe"] is True

        def scrape():
            try:
                with urllib.request.urlopen(
                        f"http://127.0.0.1:{port}/metrics",
                        timeout=2) as r:
                    return r.read().decode()
            except OSError:
                return ""

        wait_until(lambda: "tpumon_relay_up" in scrape(),
                   what="metrics scrape")
        text = scrape()
        assert "tpumon_relay_upstream_ticks_total" in text
        assert "tpumon_stream_subscribers" in text
    finally:
        if reader is not None and reader.poll() is None:
            reader.kill()
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)
        server.close()


def test_stream_cli_retry_reconnects_with_marker(tmp_path):
    """tpumon-stream --retry: survives upstream connection loss,
    prints the reconnect marker, resyncs via the fresh keyframe and
    keeps emitting ticks; --retry with --count is rejected."""

    from tpumon_torch.cli.stream import main as stream_main

    with pytest.raises(SystemExit) as exc:
        stream_main(["--connect", "unix:/nonexistent", "--retry",
                     "-c", "3"])
    assert exc.value.code == 2

    server = FrameServer()
    hub = StreamHub(server)
    sockdir = tempfile.mkdtemp(prefix="tpumon-retrytest-")
    path = os.path.join(sockdir, "origin.sock")
    addr = server.add_unix_listener(hub, path)
    pub = hub.publisher("")
    server.start()
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.Popen(
        [sys.executable, "-m", "tpumon_torch.cli.stream",
         "--connect", addr, "--format", "json", "--retry"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env)
    try:
        pub.publish({0: {1: 1.0}}, now=100.0)
        wait_until(lambda: pub.subscribers == 1, what="CLI attach")
        pub.publish({0: {1: 2.0}}, now=101.0)
        # cut the connection out from under the CLI
        server.kill_connections(f"unix:{path}")
        # let it reconnect (jittered 0.25-0.5s), then publish again
        wait_until(lambda: pub.subscribers == 1, timeout=15.0,
                   what="CLI re-attach")
        pub.publish({0: {1: 3.0}}, now=102.0)

        deadline = time.monotonic() + 15.0
        seen = b""
        while time.monotonic() < deadline:
            # the CLI streams forever under --retry: read its stdout
            # incrementally until the post-reconnect tick shows up
            os.set_blocking(proc.stdout.fileno(), False)
            chunk = proc.stdout.read()
            if chunk:
                seen += chunk
            if b'"ts": 102.0' in seen or b'"ts":102.0' in seen:
                break
            time.sleep(0.05)
        proc.terminate()
        _out, err = proc.communicate(timeout=10)
        seen += _out or b""
        assert b'102.0' in seen, seen
        assert b"upstream lost" in err
        assert b"reconnected" in err
    finally:
        if proc.poll() is None:
            proc.kill()
        server.close()
