"""The port's native poll engine (``_tpumon_torch_poll``, built from
``tpumon_torch/native/poll/``; :class:`tpumon_torch.fleetpoll.
NativeFleetPoller`) against the Python pollers, on the CPU.

Each test makes the port's codec and poll extensions the loaded planes
(:func:`test_torch_fleet.use_native`: built at first use; a failed build
fails the test).

* Three planes over three farms running one schedule made from a numpy
  seed (values churn, events ride, agents die and come back, connections
  are killed mid-stream and frames cut mid-frame, old JSON-only agents):
  the port's ``NativeFleetPoller``, the port's ``FleetPoller`` and the
  JAX package's ``tpumon.fleetpoll.FleetPoller``.  Every tick the rows
  (every field, error strings included), the changed flags, the bytes
  per host and per tick and the raw snapshots are identical.  Tolerance:
  none, but the two things a farm or a clock decides: socket paths and the
  ``backoff N.Ns`` wait are scrubbed, as the reference's harness does.
* The reference's own native cases (``tests/test_fleet_native.py``) run
  on the port (:func:`test_torch_fleet.run_on_port`, its ``TwinFleets``
  rebound to the port's farm and pollers), but its randomized full-matrix
  case, which runs here twice, deterministically: a failed host's backoff
  deadline there (0.5 s) could fall between the two planes' ticks, so a
  row read ``backoff ...`` on one plane and a redial's error on the other.
  Here the same schedule runs once with ``backoff_base_s=0`` (every failed
  host redials every tick: recovery) and once with a backoff longer than
  the run (every failed host stays in backoff).
* The reference's poll cases that take a poller factory
  (``tests/test_fleet_poll.py``) and the supervisor's re-admission case
  run again on the native engine.
* The smoke's flat poller process (``chip_smoke.FLEET_FLAT``) on each
  plane, as ``TPUMON_NATIVE`` selects it.
* The plain ``poll-smoke`` driver runs (its ThreadSanitizer build opt-in:
  ``TPUMON_RUN_SANITIZERS=1``).
"""

import inspect
import json
import os
import subprocess
import sys
import time
import types

import numpy as np
import pytest

import test_fleet_native as REF_NATIVE
import test_fleet_poll as REF_POLL
import test_supervisor as REF_SUP
from test_torch_fleet import (_port_twin, reference_cases, run_on_port,
                              use_native)
from tpumon import agentsim as JS
from tpumon import events as JE
from tpumon import fleetpoll as JP
from tpumon_torch import _build
from tpumon_torch import agentsim as TS
from tpumon_torch import events as TE
from tpumon_torch import fleetpoll as TP
from tpumon_torch import log as TL

FIDS = list(REF_NATIVE.FIDS)
#: long enough that a failed host stays in backoff for the whole run
HELD_S = 3600.0
BACKOFFS = {"redial": {"backoff_base_s": 0.0},
            "held": {"backoff_base_s": HELD_S, "backoff_max_s": HELD_S}}


@pytest.fixture
def native(monkeypatch):
    use_native(monkeypatch)


# -- three planes, one schedule ----------------------------------------------------

class ThreeFleets:
    """One farm per plane, every sim scripted alike: the port's native
    poller, the port's Python poller and the JAX package's poller."""

    def __init__(self, rng, hosts, **kw):
        self.mods = (TS, TS, JS)
        self.farms = [m.AgentFarm() for m in self.mods]
        self.sims = ([], [], [])
        self.addrs = ([], [], [])
        for i in range(hosts):
            values = {c: {f: self._value(rng) for f in FIDS}
                      for c in range(int(rng.integers(1, 5)))}
            for side, mod in enumerate(self.mods):
                sim = mod.SimAgent(support_sweep_frame=(i % 3 != 2))
                sim.values = {c: dict(v) for c, v in values.items()}
                self.sims[side].append(sim)
                self.addrs[side].append(self.farms[side].add(sim))
        for f in self.farms:
            f.start()
        kw.setdefault("backoff_jitter", lambda: 1.0)
        self.pollers = (TP.NativeFleetPoller(self.addrs[0], FIDS, **kw),
                        TP.FleetPoller(self.addrs[1], FIDS, **kw),
                        JP.FleetPoller(self.addrs[2], FIDS, **kw))
        self.maps = tuple({a: i for i, a in enumerate(self.addrs[s])}
                          for s in range(3))

    @staticmethod
    def _value(rng):
        k = int(rng.integers(0, 3))
        return (int(rng.integers(0, 501)) if k == 0 else
                round(float(rng.random()), 3) if k == 1 else
                f"s{int(rng.integers(0, 10))}")

    def each_sim(self, i):
        return tuple(self.sims[s][i] for s in range(3))

    def kill_connections(self, i):
        for side in range(3):
            self.farms[side].kill_connections(self.addrs[side][i])
        time.sleep(0.05)  # the kills land on the farms' loop threads

    def tick(self, ctx):
        rows = [p.poll() for p in self.pollers]
        got = [REF_NATIVE._rows(r, self.maps[s]) for s, r in enumerate(rows)]
        assert got[0] == got[1] == got[2], ctx
        flags = [p.last_changed_flags() for p in self.pollers]
        assert flags[0] == flags[1] == flags[2], ctx
        per = [[p.per_host_tick_bytes()[a] for a in self.addrs[s]]
               for s, p in enumerate(self.pollers)]
        assert per[0] == per[1] == per[2], ctx
        tot = [(p.tick_bytes_sent, p.tick_bytes_recv) for p in self.pollers]
        assert tot[0] == tot[1] == tot[2], ctx
        snaps = [[p.raw_snapshots()[a] for a in self.addrs[s]]
                 for s, p in enumerate(self.pollers)]
        assert snaps[0] == snaps[1] == snaps[2], ctx
        return rows[0]

    def close(self):
        for p in self.pollers:
            p.close()
        for f in self.farms:
            f.close()


def _schedule(t, rng, tick, hosts, seq):
    """One tick of the seeded fault matrix, applied to every plane."""

    for i in range(hosts):
        sims = t.each_sim(i)
        r = rng.random()
        if r < 0.35:                                   # value churn
            chip = int(rng.choice(sorted(sims[0].values)))
            fid = FIDS[int(rng.integers(0, len(FIDS)))]
            v = (int(rng.integers(0, 10**6)) if rng.random() < 0.5
                 else round(float(rng.random()) * 100, 3))
            for s in sims:
                s.values[chip][fid] = v
        elif r < 0.45:                                 # piggybacked event
            seq[i] += 1
            for s, E in zip(sims, (TE, TE, JE)):
                s.events.append(E.Event(
                    etype=E.EventType.THERMAL, timestamp=10.0 + tick,
                    seq=seq[i], chip_index=0, uuid="u", message=f"m{tick}"))
        elif r < 0.52:                                 # agent dies
            for s in sims:
                s.dead = True
        elif r < 0.60 and sims[0].dead:                # ...and comes back
            for s in sims:
                s.dead = False
        elif r < 0.66:                                 # mid-stream kill
            t.kill_connections(i)
        elif r < 0.70:                                 # mid-frame kill
            for s in sims:
                s.kill_mid_frame_once = True


@pytest.mark.parametrize("backoff", sorted(BACKOFFS))
@pytest.mark.parametrize("seed", range(3))
def test_three_planes_identical_over_the_fault_matrix(native, seed, backoff):
    rng = np.random.default_rng(seed)
    hosts = 8
    t = ThreeFleets(rng, hosts, timeout_s=2.0, **BACKOFFS[backoff])
    try:
        seq = [0] * hosts
        down = 0
        for tick in range(14):
            _schedule(t, rng, tick, hosts, seq)
            rows = t.tick(f"seed {seed} tick {tick}")
            down += sum(not s.up for s in rows)
        assert down > 0  # the matrix reached its failure rows
        assert t.pollers[0].hello_rpcs_total == \
            t.pollers[1].hello_rpcs_total == t.pollers[2].hello_rpcs_total
    finally:
        t.close()


# -- the reference's native cases on the port --------------------------------------

def _rebound_class(cls, g):
    """``cls`` with every method reading the globals ``g``."""

    ns = {k: (types.FunctionType(v.__code__, g, v.__name__, v.__defaults__,
                                 v.__closure__)
              if isinstance(v, types.FunctionType) else v)
          for k, v in vars(cls).items()
          if k not in ("__dict__", "__weakref__")}
    return type(cls.__name__, cls.__bases__, ns)


def _port_twins():
    g = {k: _port_twin(v) for k, v in vars(REF_NATIVE).items()}
    g["TwinFleets"] = _rebound_class(REF_NATIVE.TwinFleets, g)
    return g["TwinFleets"]


@pytest.fixture
def port_twins():
    made, cls = [], _port_twins()

    def factory(**inject):
        def make(specs, **kw):
            t = cls(specs, **{**inject, **kw})
            made.append(t)
            return t
        return make

    yield cls, factory
    for t in made:
        t.close()


def _run_ref_case(ref_module, case, monkeypatch, **fixtures):
    """``run_on_port`` with ``from tpumon import fleetpoll`` inside a case
    reaching the port's module too (the package attribute, not only
    ``sys.modules``)."""

    import tpumon

    monkeypatch.setattr(tpumon, "fleetpoll", TP)
    run_on_port(ref_module, case, monkeypatch, **fixtures)


#: run below on two deterministic backoff settings instead (module
#: docstring)
FULL_MATRIX = "test_randomized_differential_full_matrix"
NATIVE_CASES = reference_cases(REF_NATIVE, {FULL_MATRIX})


@pytest.mark.parametrize("case", NATIVE_CASES)
def test_reference_native_poll_case_holds_on_the_port(case, native,
                                                      port_twins, tmp_path,
                                                      monkeypatch):
    cls, factory = port_twins
    _run_ref_case(REF_NATIVE, case, monkeypatch,
                  names={"TwinFleets": cls}, twins_factory=factory(),
                  tmp_path=tmp_path)


@pytest.mark.parametrize("backoff", sorted(BACKOFFS))
def test_reference_full_matrix_holds_deterministically(backoff, native,
                                                       port_twins,
                                                       monkeypatch):
    cls, factory = port_twins
    _run_ref_case(REF_NATIVE, FULL_MATRIX, monkeypatch,
                  names={"TwinFleets": cls},
                  twins_factory=factory(**BACKOFFS[backoff]))


# -- the reference's poll cases on the engine --------------------------------------

FP_CASES = [n for n in reference_cases(REF_POLL, set())
            if "FP" in inspect.signature(getattr(REF_POLL, n)).parameters]


@pytest.fixture
def port_farm():
    f = TS.AgentFarm()
    yield f
    f.close()


@pytest.mark.parametrize("case", FP_CASES)
def test_reference_poll_case_holds_on_the_engine(case, native, port_farm,
                                                 tmp_path, monkeypatch):
    # the edge-triggered logging case reads the "tpumon" logger at the
    # level the package's first log line sets
    TL._ensure_handler()
    _run_ref_case(REF_POLL, case, monkeypatch, farm=port_farm,
                  tmp_path=tmp_path,
                  FP=lambda *a, **kw: TP.create_fleet_poller(
                      *a, native=True, **kw))


def test_reference_supervisor_readmission_holds_on_the_engine(
        native, port_farm, tmp_path, monkeypatch):
    _run_ref_case(REF_SUP, "test_reset_backoff_waives_reconnect_budget_charge",
                  monkeypatch, farm=port_farm, tmp_path=tmp_path, native=True)


# -- the smoke's flat poller process -----------------------------------------------

@pytest.mark.parametrize("plane, want", [("0", "FleetPoller"),
                                         ("1", "NativeFleetPoller")])
def test_smoke_flat_script_on_each_plane(plane, want, port_farm, tmp_path,
                                         monkeypatch):
    """``chip_smoke.FLEET_FLAT`` over 9 simulated hosts under the import
    guard, with ``TPUMON_NATIVE`` selecting the plane: its poller is the
    plane's, every host is up every tick, every simulated row is its
    farm's values, and both planes print the same table."""

    from test_torch_fleetshard import _smoke_module, import_guard
    from tpumon_torch.cli.fleet import _FIELDS

    _build.native()
    refused = import_guard(tmp_path, monkeypatch)
    chips, addrs = 2, []
    for i in range(-1, 8):  # the first target stands for the card's host
        sim = TS.SimAgent()
        sim.values = TS._bench_host_values(max(i, 0), chips, _FIELDS)
        addrs.append(port_farm.add(sim))
    port_farm.start()
    targets = tmp_path / "fleet.targets"
    targets.write_text("\n".join(addrs) + "\n")
    r = subprocess.run(
        [sys.executable, "-c", _smoke_module().FLEET_FLAT, str(targets), "3",
         str(chips)], cwd=os.path.dirname(os.path.dirname(
             os.path.abspath(__file__))),
        env=dict(os.environ, TPUMON_NATIVE=plane), capture_output=True,
        text=True, timeout=90)
    assert r.returncode == 0, r.stderr[-2000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["poller"] == want
    assert [t["up"] for t in out["ticks"]] == [9, 9, 9]
    assert out["n_mismatched"] == 0
    assert refused.read_text() == ""


# -- the smoke driver ------------------------------------------------------------

def test_poll_smoke_driver_runs():
    r = subprocess.run([str(_build.native("poll-smoke"))],
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.startswith("OK records=")


@pytest.mark.skipif("TPUMON_RUN_SANITIZERS" not in os.environ,
                    reason="sanitizer runs are opt-in "
                           "(TPUMON_RUN_SANITIZERS=1)")
def test_poll_smoke_under_tsan():
    t = _build.NATIVE_TARGETS["poll-smoke"]
    tsan = _build.NativeTarget("poll-smoke-tsan", True, t.main, t.deps,
                               ("-fsanitize=thread",) + t.link)
    r = subprocess.run([str(_build._compile_native(tsan, None))],
                       capture_output=True, text=True, timeout=300,
                       env=dict(os.environ, TSAN_OPTIONS="halt_on_error=1"))
    assert r.returncode == 0, r.stderr
    assert "ThreadSanitizer" not in r.stderr
    assert r.stdout.startswith("OK records=")


def test_fleet_modules_load_the_engine_without_jax_or_torch():
    """A fresh fleet process picks the engine when it is built and
    imports no ``tpumon``, ``jax`` or ``torch`` on the way."""

    _build.native()
    code = ("import sys\n"
            "from tpumon_torch import fleetpoll\n"
            "p = fleetpoll.create_fleet_poller(['unix:/nonexistent.sock'], "
            "[155])\n"
            "print(type(p).__name__, sorted(m for m in sys.modules if "
            "m.split('.')[0] in ('tpumon', 'jax', 'jaxlib', 'torch')))\n"
            "p.close()\n")
    env = dict(os.environ, PYTHONPATH=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env.pop("TPUMON_NATIVE", None)
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.split() == ["NativeFleetPoller", "[]"]
