"""The port's native codec (``_tpumon_torch_codec``, built from
``tpumon_torch/native/codec/``) against the JAX package's pure-Python
codec, on the CPU.

Each test makes the extension the loaded plane (:func:`use_native`: built
by ``tpumon_torch._build`` at first use, a failed build fails the test)
and holds the port's native facades to the JAX package's Python classes
on inputs made from a numpy seed:

* ``SweepFrameEncoder``'s bytes equal ``tpumon.sweepframe.
  PySweepFrameEncoder``'s over seeded sweeps (partial frames, events,
  blanks and appears, removed chips, non-finite values, |v| around the
  9e15 integral-dump limit, index-only frames, mid-stream keyframes);
* ``SweepFrameDecoder``'s ``apply``/``try_apply`` (the receive buffer
  growing one byte at a time), ``materialize``, ``mirror_snapshot`` and
  ``last_changes`` equal ``PySweepFrameDecoder``'s;
* ``host_aggregate`` equals ``tpumon.fleetpoll.aggregate_host_sample``;
* ``BurstAccumulator``'s fold, ``fold_series``, harvest and anchors
  equal ``tpumon.burst.PyBurstAccumulator``'s.

Tolerance: none (bytes, and ``==`` with types).  The reference's own
native-codec cases (``tests/test_codec_native.py``) and the native
backend of ``tests/test_sweepframe_differential.py`` run on the port
(:func:`test_torch_fleet.run_on_port`); the cases whose subprocess code
names the JAX package have port versions here (the ``TPUMON_NATIVE``
contract, a stale build never loaded), with a stale-constant rejection,
both packages' extensions in one process, and the plain ``codec-smoke``
driver (its ThreadSanitizer build opt-in: ``TPUMON_RUN_SANITIZERS=1``).
"""

import os
import shutil
import subprocess
import sys
import sysconfig
import threading

import numpy as np
import pytest

import test_codec_native as REF_NATIVE
import test_sweepframe_differential as REF_DIFF
from test_torch_fleet import reference_cases, run_on_port, use_native
from test_torch_sweepframe import FIDS, _events, _sweeps
from tpumon import burst as JB
from tpumon import events as JEV
from tpumon import fleetpoll as JP
from tpumon import sweepframe as JS
from tpumon_torch import _build
from tpumon_torch import _codec as TC
from tpumon_torch import burst as TB
from tpumon_torch import events as TEV
from tpumon_torch import sweepframe as TS

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEEDS = range(6)
#: values at the edges of the number rule (finite integral doubles below
#: 9e15 travel as ints) and of the 64-bit varints
EDGES = (9e15 - 1.0, 9e15, -9e15 + 1.0, -9e15, 9e15 + 2.0, 2.0 ** 53,
         2 ** 62, -(2 ** 63), 2 ** 63 - 1, 0.5, -0.0, 1e300, -1e-300)


@pytest.fixture
def native(monkeypatch):
    use_native(monkeypatch)
    return TC.lib


def _edgy_sweeps(seed, n=12):
    """``_sweeps(seed)`` with the EDGES values planted on a seeded share
    of the entries."""

    rng = np.random.default_rng(500 + seed)
    out = []
    for snap in _sweeps(seed, n):
        for vals in snap.values():
            for f in list(vals):
                if rng.random() < 0.2:
                    vals[f] = EDGES[int(rng.integers(0, len(EDGES)))]
        out.append(snap)
    return out


# -- the encoder -----------------------------------------------------------------

@pytest.mark.parametrize("seed", SEEDS)
def test_native_encoder_bytes_equal_the_reference(native, seed):
    start = 0 if seed % 2 == 0 else 17 + seed  # a mid-stream keyframe
    ref, port = JS.PySweepFrameEncoder(start), TS.SweepFrameEncoder(start)
    assert port._nat is not None
    for k, snap in enumerate(_edgy_sweeps(seed)):
        if k % 5 == 4:
            a, b = ref.encode_index_only_frame(), \
                port.encode_index_only_frame()
        elif k % 5 == 2:
            part = {c: v for c, v in snap.items() if c != k % 3}
            a = ref.encode_frame(part, partial=True)
            b = port.encode_frame(part, partial=True)
        else:
            a = ref.encode_frame(snap, _events(JEV, seed, k))
            b = port.encode_frame(snap, _events(TEV, seed, k))
        assert a == b, (seed, k)
        assert ref.table_entries() == port.table_entries()
    port.close()


# -- the decoder -----------------------------------------------------------------

def _event_rows(events):
    return [(int(e.etype), e.seq, e.chip_index, e.timestamp, e.uuid,
             e.message) for e in events]


@pytest.mark.parametrize("seed", SEEDS)
def test_native_decoder_equals_the_reference(native, seed):
    """The reference's frames into both decoders: ``apply`` on whole
    payloads, and ``try_apply`` on a buffer that grows one byte at a time
    (every split point), against ``try_split_frame`` + ``apply``."""

    enc = JS.PySweepFrameEncoder()
    frames = [enc.encode_index_only_frame() if k % 5 == 4
              else enc.encode_frame(snap, _events(JEV, seed, k))
              for k, snap in enumerate(_edgy_sweeps(seed))]
    req = [(c, list(FIDS) + [999]) for c in range(4)] + [(1, [150, 155])]
    ref, whole = JS.PySweepFrameDecoder(), TS.SweepFrameDecoder()
    assert whole._nat is not None
    for frame in frames:
        payload, _ = JS.split_frame(frame)
        a, b = ref.apply(payload), whole.apply(payload)
        assert _event_rows(a) == _event_rows(b)
        assert ref.last_changes == whole.last_changes
        assert ref.mirror_snapshot() == whole.mirror_snapshot()
        assert ref.materialize(req) == whole.materialize(req)
        assert ref.mirror_entries() == whole.mirror_entries()
        assert ref._next_frame_index == whole._next_frame_index
    ref, dec = JS.PySweepFrameDecoder(), TS.SweepFrameDecoder()
    blob, buf = b"".join(frames), bytearray()
    done = 0
    for byte in blob:
        buf.append(byte)
        got = dec.try_apply(buf)
        want = JS.try_split_frame(buf)
        if got is None:
            assert want is None
            continue
        used, events = got
        payload, want_used = want
        assert used == want_used
        assert _event_rows(events) == _event_rows(ref.apply(payload))
        assert dec.last_changes == ref.last_changes
        assert dec.mirror_snapshot() == ref.mirror_snapshot()
        del buf[:used]
        done += 1
    assert done == len(frames) and not buf
    assert dec.materialize(req) == ref.materialize(req)
    for d in (whole, dec):
        d.close()


def test_native_decoder_errors_equal_the_reference(native):
    """A frame-index discontinuity and malformed payloads (a truncated
    varint, chip block or event, an unknown field) raise ``ValueError``
    with the reference's words on both decoders."""

    enc = JS.PySweepFrameEncoder()
    f0, f1 = (JS.split_frame(enc.encode_frame({0: {150: i}}))[0]
              for i in (1, 2))
    for payload in (f1, f0[:-2], b"\x08", b"\x08\x00\x38\x01",
                    b"\x08\x00\x12\x05\x08\x96", b"\x08\x00\x22\x09abc"):
        errs = []
        for dec in (JS.PySweepFrameDecoder(), TS.SweepFrameDecoder()):
            try:
                dec.apply(payload)
                errs.append(None)
            except ValueError as e:
                errs.append(str(e))
        assert errs[0] == errs[1] and errs[0], (payload, errs)


# -- the fleet aggregate -----------------------------------------------------------

@pytest.mark.parametrize("seed", range(4))
def test_host_aggregate_equals_the_reference_aggregate(native, seed):
    """``host_aggregate`` off the native mirror == the JAX package's
    ``aggregate_host_sample`` over the materialized snapshot, by ``repr``
    (int sums stay int, float means float, absent aggregates None)."""

    from tpumon_torch.fleetpoll import FleetPoller

    agg_fids = FleetPoller([], [])._agg_fids
    rng = np.random.default_rng(seed)
    fids = list(agg_fids) + [51, 100]
    enc, dec = JS.PySweepFrameEncoder(), TS.SweepFrameDecoder()
    nchips = int(rng.integers(1, 6))
    reqs = [(c, fids) for c in range(nchips)]
    values = {}
    for step in range(10):
        for c in range(nchips):
            if rng.random() < 0.15:
                values.pop(c, None)
                continue
            vc = values.setdefault(c, {})
            for f in fids:
                r = rng.random()
                vc[f] = (None if r < 0.15 else
                         int(rng.integers(0, 500)) if r < 0.4 else
                         round(float(rng.uniform(0, 500.0)), 3) if r < 0.7
                         else bool(rng.integers(0, 2)) if r < 0.8
                         else "strval" if r < 0.9 else
                         float(rng.integers(0, 100)))
        frame = enc.encode_frame({c: dict(v) for c, v in values.items()})
        dec.apply(JS.split_frame(frame)[0])
        agg = dec.host_aggregate(reqs, nchips, agg_fids)
        want = JP.aggregate_host_sample("a", nchips, "drv",
                                        dec.materialize(reqs), 7)
        got = JP.HostSample(
            address="a", up=True, chips=nchips, driver="drv",
            power_w=agg[2], max_temp_c=agg[3], mean_tc_util=agg[4],
            mean_hbm_util=agg[5], hbm_used_mib=agg[6], hbm_total_mib=agg[7],
            links_up=agg[8], events=7, live_fields=agg[0],
            dead_chips=agg[1])
        assert repr(got) == repr(want), (seed, step)
    dec.close()


# -- the burst accumulator -----------------------------------------------------------

@pytest.mark.parametrize("seed", range(4))
def test_native_burst_equals_the_reference(native, seed):
    """Fold, ``fold_series``, harvest (values and types, and its frame
    bytes) and the anchors carried across the sampler's swap, native
    against the JAX package's ``PyBurstAccumulator``."""

    rng = np.random.default_rng(100 + seed)
    nat, ref = TB.BurstAccumulator(), JB.PyBurstAccumulator()
    assert nat._nat is not None
    enc_n, enc_r = TS.SweepFrameEncoder(), JS.PySweepFrameEncoder()
    pool = [float("nan"), float("inf"), None, "bad", [1], True, 9e15 - 1.0]
    t = 0.0
    for step in range(40):
        for _ in range(int(rng.integers(0, 8))):
            chip, fid = int(rng.integers(0, 3)), int(rng.choice(
                [155, 203, 204, 206]))
            n = int(rng.integers(0, 12))
            ts = [t + j * 0.01 for j in range(n)]
            vs = [pool[int(rng.integers(0, len(pool)))] if rng.random() < 0.3
                  else (float(rng.uniform(-50.0, 50.0)) if rng.random() < 0.5
                        else int(rng.integers(0, 10**6)))
                  for _ in range(n)]
            if rng.random() < 0.5:
                nat.fold_series(chip, fid, ts, vs)
                ref.fold_series(chip, fid, ts, vs)
            else:
                for tt, vv in zip(ts, vs):
                    if isinstance(vv, (int, float)):
                        nat.fold(chip, fid, tt, vv)
                        ref.fold(chip, fid, tt, vv)
        t += 1.0
        assert nat.entries() == ref.entries(), (seed, step)
        if rng.random() < 0.6:
            hn, hr = nat.harvest(), ref.harvest()
            assert {c: {f: (type(v), repr(v)) for f, v in vals.items()}
                    for c, vals in hn.items()} == \
                {c: {f: (type(v), repr(v)) for f, v in vals.items()}
                 for c, vals in hr.items()}, (seed, step)
            assert enc_n.encode_frame(hn) == enc_r.encode_frame(hr)
        if rng.random() < 0.25:
            nat2, ref2 = TB.BurstAccumulator(), JB.PyBurstAccumulator()
            nat2.adopt_anchors(nat)
            ref2.adopt_anchors(ref)
            nat, ref = nat2, ref2


def test_two_threads_encode_at_once_equal_the_reference(native):
    """Two threads, each with its own native encoder (the GIL released
    inside every call), emit the reference's bytes for their sweeps."""

    out = {}

    def work(seed):
        enc, ref = TS.SweepFrameEncoder(), JS.PySweepFrameEncoder()
        try:
            for _ in range(20):
                for snap in _edgy_sweeps(seed):
                    if enc.encode_frame(snap) != ref.encode_frame(snap):
                        out[seed] = "bytes differ"
                        return
            out[seed] = "ok"
        except Exception as e:  # surfaced below
            out[seed] = repr(e)

    threads = [threading.Thread(target=work, args=(s,)) for s in (1, 2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert out == {1: "ok", 2: "ok"}


# -- the reference's cases on the port -----------------------------------------------

#: their subprocess code names the JAX package: port versions below
NATIVE_CASES = reference_cases(REF_NATIVE, {
    "test_env_zero_forces_pure_python",
    "test_env_unset_picks_native_when_built",
    "test_env_one_fails_loudly_without_extension"})


@pytest.mark.parametrize("case", NATIVE_CASES)
def test_reference_native_codec_case_holds_on_the_port(case, native,
                                                        monkeypatch):
    run_on_port(REF_NATIVE, case, monkeypatch)


#: the codec cases of the differential suite; the socket cases there hold
#: the agent client, not the codec
DIFF_CASES = ("test_codec_differential_random_churn",
              "test_codec_cross_backend_frames_byte_identical",
              "test_codec_steady_state_frames_are_tiny",
              "test_burst_harvests_ride_the_codec_like_any_field",
              "test_decoder_rejects_frame_index_discontinuity")


@pytest.mark.parametrize("case", DIFF_CASES)
def test_reference_differential_case_holds_natively(case, native,
                                                    monkeypatch):
    run_on_port(REF_DIFF, case, monkeypatch,
                codec_backend=(TS.SweepFrameEncoder, TS.SweepFrameDecoder))


# -- the TPUMON_NATIVE contract, in fresh processes ------------------------------------

STATE = ("from tpumon_torch import _codec, _poll\n"
         "from tpumon_torch.burst import BurstAccumulator\n"
         "from tpumon_torch.sweepframe import SweepFrameEncoder\n"
         "print(int(_codec.active()), int(_poll.active()),\n"
         "      int(SweepFrameEncoder()._nat is not None),\n"
         "      int(BurstAccumulator()._nat is not None))\n")


def _state(value, cwd=REPO, code=STATE, extra_path=None):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        ([extra_path] if extra_path else []) + [cwd]))
    env.pop("TPUMON_NATIVE", None)
    if value is not None:
        env["TPUMON_NATIVE"] = value
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)


@pytest.mark.parametrize("value, want", [("0", "0 0 0 0"), (None, "1 1 1 1"),
                                         ("1", "1 1 1 1")])
def test_env_contract_with_the_build(value, want):
    """``0`` never loads; unset and ``1`` load the build of these sources
    (both extensions) and the facades go native."""

    _build.native()
    r = _state(value)
    assert r.returncode == 0, r.stderr
    assert r.stdout.split() == want.split()


def _tree(tmp_path, build: bool, stale: bool = False):
    """A copy of the package's loaders and native sources (no JAX
    package, nothing built) at ``tmp_path/tree``; with ``build`` the real
    builds of the two extensions are copied under the names the copy's
    own sources hash to; ``stale`` then edits the codec binding (a
    source of the codec extension only) after."""

    tree = tmp_path / "tree"
    pkg = tree / "tpumon_torch"
    pkg.mkdir(parents=True)
    for name in ("_build.py", "_codec.py", "_poll.py"):
        shutil.copy(os.path.join(REPO, "tpumon_torch", name), pkg / name)
    (pkg / "__init__.py").write_text("")
    shutil.copytree(os.path.join(REPO, "tpumon_torch", "native"),
                    pkg / "native",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copytree(os.path.join(REPO, "tpumon_torch", "testlib"),
                    pkg / "testlib",
                    ignore=shutil.ignore_patterns("__pycache__"))
    if build:
        built = _build.native()
        dst = tree / "build" / "tpumon_torch"
        dst.mkdir(parents=True)
        for name in (TC.NAME, "_tpumon_torch_poll"):
            shutil.copy(built[name], dst / built[name].name)
    if stale:
        with open(pkg / "native" / "codec" / "module.cc", "a") as f:
            f.write("// edited\n")
    return str(tree)


LOADERS = ("from tpumon_torch import _codec, _poll\n"
           "print(int(_codec.active()), int(_poll.active()))\n")


def test_env_one_fails_loudly_without_the_build(tmp_path):
    tree = _tree(tmp_path, build=False)
    for module in ("_codec", "_poll"):
        r = _state("1", cwd=tree, code=f"import tpumon_torch.{module}")
        assert r.returncode != 0
        assert "TPUMON_NATIVE=1" in r.stderr and "not built" in r.stderr
    r = _state(None, cwd=tree, code=LOADERS)
    assert r.returncode == 0 and r.stdout.split() == ["0", "0"], r.stderr


def test_only_the_build_of_these_sources_loads(tmp_path):
    """The copied builds load in a copy of the same sources; after one
    source changes, the same files are stale: never loaded, and
    ``TPUMON_NATIVE=1`` refuses to start."""

    tree = _tree(tmp_path / "a", build=True)
    r = _state(None, cwd=tree, code=LOADERS)
    assert r.returncode == 0 and r.stdout.split() == ["1", "1"], r.stderr
    tree = _tree(tmp_path / "b", build=True, stale=True)
    r = _state(None, cwd=tree, code=LOADERS)
    assert r.returncode == 0 and r.stdout.split() == ["0", "1"], r.stderr
    r = _state("1", cwd=tree, code="import tpumon_torch._codec")
    assert r.returncode != 0 and "not built" in r.stderr


def test_no_module_is_imported_off_sys_path(tmp_path):
    """A module named like the extension on ``sys.path`` is never
    imported: with nothing built, the codec stays on Python."""

    tree = _tree(tmp_path, build=False)
    shadow = tmp_path / "shadow"
    shadow.mkdir()
    for name in (TC.NAME, "_tpumon_torch_poll"):
        (shadow / f"{name}.py").write_text(
            "raise SystemExit('imported off sys.path')\n")
    r = _state(None, cwd=tree, code=LOADERS, extra_path=str(shadow))
    assert r.returncode == 0 and r.stdout.split() == ["0", "0"], r.stderr


REJECT = ("import types\n"
          "from tpumon_torch import _codec\n"
          "assert _codec.active()\n"
          "_codec.lib = types.SimpleNamespace(SWEEP_FRAME_MAGIC={frame},\n"
          "    SWEEP_REQ_MAGIC=0xA6, NUM_INT_LIMIT=9e15, BURST_ID_BASE={base})\n"
          "import tpumon_torch.burst\n"
          "print(int(_codec.active()), _codec.error)\n")


@pytest.mark.parametrize("frame, base, word", [
    (0xA8, 2000, "wire constants"), (0xA9, 3000, "BURST_ID_BASE")])
def test_stale_constants_are_rejected(frame, base, word):
    """An extension whose wire constants disagree with the Python
    declarations is refused at import: the Python plane serves (unset),
    or the import fails (``TPUMON_NATIVE=1``)."""

    _build.native()
    code = REJECT.format(frame=frame, base=base)
    r = _state(None, code=code)
    assert r.returncode == 0, r.stderr
    assert r.stdout.startswith("0 ") and word in r.stdout
    r = _state("1", code=code)
    assert r.returncode != 0
    assert "TPUMON_NATIVE=1" in r.stderr and word in r.stderr


def test_both_packages_extensions_load_in_one_process(tmp_path):
    """The JAX package's codec extension (its sources compiled into a
    temporary directory) and the port's load side by side under their
    own names and encode the same bytes."""

    ref_so = str(tmp_path / ("_tpumon_codec" +
                             sysconfig.get_config_var("EXT_SUFFIX")))
    src = os.path.join(REPO, "native", "codec")
    subprocess.run(["g++", *_build.CXXFLAGS, *_build.PY_WARN_WAIVER, "-I",
                    sysconfig.get_paths()["include"], "-I", src, "-shared",
                    "-o", ref_so, os.path.join(src, "module.cc")],
                   check=True, capture_output=True, timeout=300)
    _build.native()
    code = (
        "import importlib.util, sys\n"
        "spec = importlib.util.spec_from_file_location("
        f"'_tpumon_codec', {ref_so!r})\n"
        "ref = importlib.util.module_from_spec(spec)\n"
        "spec.loader.exec_module(ref)\n"
        "from tpumon_torch import _codec\n"
        "port = _codec.lib\n"
        "assert port is sys.modules['_tpumon_torch_codec'] is not ref\n"
        "chips = {0: {150: 1, 155: 2.5, 203: None}, 3: {150: 'x'}}\n"
        "a = ref.Encoder(start_index=0).encode_frame(chips, b'', False)\n"
        "b = port.Encoder(start_index=0).encode_frame(chips, b'', False)\n"
        "print(a == b, len(a))\n")
    r = _state(None, code=code)
    assert r.returncode == 0, r.stderr
    assert r.stdout.split()[0] == "True"


# -- the smoke driver ------------------------------------------------------------

def test_codec_smoke_driver_runs():
    r = subprocess.run([str(_build.native("codec-smoke"))],
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert "codec smoke OK" in r.stdout


@pytest.mark.skipif("TPUMON_RUN_SANITIZERS" not in os.environ,
                    reason="sanitizer runs are opt-in "
                           "(TPUMON_RUN_SANITIZERS=1)")
def test_codec_smoke_under_tsan():
    t = _build.NATIVE_TARGETS["codec-smoke"]
    tsan = _build.NativeTarget("codec-smoke-tsan", True, t.main, t.deps,
                               ("-fsanitize=thread",) + t.link)
    r = subprocess.run([str(_build._compile_native(tsan, None))],
                       capture_output=True, text=True, timeout=300,
                       env=dict(os.environ, TSAN_OPTIONS="halt_on_error=1"))
    assert r.returncode == 0, r.stderr
    assert "ThreadSanitizer" not in r.stderr
    assert "codec smoke OK" in r.stdout
