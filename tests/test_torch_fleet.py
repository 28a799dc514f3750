"""The port's fleet poller and fleet CLI (``tpumon_torch.fleetpoll``,
``tpumon_torch.cli.fleet``) against the JAX package's (``tpumon.fleetpoll``,
``tpumon.cli.fleet``), on the CPU.

* Crossed: the reference's ``FleetPoller`` over the port's ``AgentFarm`` and
  the port's poller over the reference's farm, 16 hosts x 4 chips, 5 ticks
  of churn, an old JSON-only agent, events, a lost and returning chip: the
  ``HostSample`` rows (types included, by ``repr``) and the bytes each farm
  counted on the wire are identical every tick.  Tolerance: none.
* The reference's own failure matrix (``tests/test_fleet_poll.py``: the
  JSON-oracle pin, deadlines, backoff and its jitter, the reconnect budget,
  mid-frame deaths, edge-triggered logging, ...) runs case for case on the
  port: each case's function is rebound to the port's names
  (:func:`run_on_port`).  Its own bars hold unchanged.
* The port's poller over the port's agent (``python -m
  tpumon_torch.hostengine --fake``, frozen epoch): both packages' pollers
  read equal rows and snapshots.
* The CLI: ``render``/``check_render`` byte-equal to the reference's, and
  ``--once [--check [--expect-chips N]]`` answering with the reference
  CLI's exit codes and bytes against the same agent.
* Plane selection: ``TPUMON_NATIVE=1`` and ``native=True`` give the
  native engine's poller (``tests/test_torch_fleet_native.py`` holds it
  to both Python pollers), ``TPUMON_NATIVE=0`` the Python one.
* Imports: the five fleet modules import no ``tpumon``, ``jax`` or
  ``torch``.
"""

import dataclasses
import importlib
import inspect
import os
import random
import subprocess
import sys
import threading
import time
import types

import pytest

import test_fleet_poll as REF_POLL
from test_torch_agent import PORT_AGENT, agent_env, spawn_agent, stop_agent
from tpumon import agentsim as JS
from tpumon import events as JE
from tpumon import fleetpoll as JP
from tpumon.cli import fleet as JCF
from tpumon_torch import _build
from tpumon_torch import _codec as TC
from tpumon_torch import _poll as TPL
from tpumon_torch import agentsim as TS
from tpumon_torch import events as TE
from tpumon_torch import fleetpoll as TP
from tpumon_torch.cli import fleet as TCF

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIDS = list(TCF._FIELDS)
#: a future epoch: the port's fake agent reads t = 0, so its values hold
FROZEN = time.time() + 36000.0

#: the reference's modules a case may import inside its body; aliased to
#: the port's while the case runs
ALIASED = ("fleetpoll", "fleetshard", "supervisor", "agentsim", "cli.fleet",
           "backends.agent", "frameserver", "events", "sweepframe",
           "blackbox", "anomaly", "chaos", "cli.chaos")
#: the port's fixtures a reference case may ask for, by parameter name
PORT_FACTORY = {
    "FP": lambda: (lambda *a, **kw: TP.create_fleet_poller(
        *a, native=False, **kw)),
    "native": lambda: False,
}


# -- running a reference test case on the port ---------------------------------

def _port_twin(obj):
    """The port's module, class or function of the same name as a JAX
    package one (``tpumon.x.Y`` -> ``tpumon_torch.x.Y``); anything else as
    it is."""

    if isinstance(obj, types.ModuleType):
        name = obj.__name__
        if name == "tpumon" or name.startswith("tpumon."):
            return importlib.import_module("tpumon_torch" + name[6:])
        return obj
    mod = getattr(obj, "__module__", None)
    if (isinstance(mod, str) and mod.startswith("tpumon.")
            and hasattr(obj, "__name__")):
        return getattr(importlib.import_module("tpumon_torch" + mod[6:]),
                       obj.__name__)
    return obj


def run_on_port(ref_module, case, monkeypatch, names=None, **fixtures):
    """Run the reference test ``case`` of ``ref_module`` with every name
    it (and the module's helper functions) reads from the module bound to
    the port's twin, and the reference's modules aliased to the port's for
    imports inside its body.  ``names`` rebinds module globals besides
    (a data directory of the port's own); ``fixtures`` supply its
    parameters."""

    g = {k: _port_twin(v) for k, v in vars(ref_module).items()}
    g.update(names or {})
    for k, v in list(g.items()):
        if (isinstance(v, types.FunctionType)
                and v.__module__ == ref_module.__name__):
            g[k] = types.FunctionType(v.__code__, g, v.__name__,
                                      v.__defaults__, v.__closure__)
    for name in ALIASED:
        monkeypatch.setitem(sys.modules, "tpumon." + name,
                            importlib.import_module("tpumon_torch." + name))
    fn = g[case]
    kwargs = {}
    for p in inspect.signature(fn).parameters:
        if p in fixtures:
            kwargs[p] = fixtures[p]
        elif p == "monkeypatch":
            kwargs[p] = monkeypatch
        else:
            kwargs[p] = PORT_FACTORY[p]()
    fn(**kwargs)


def reference_cases(ref_module, skip):
    names = sorted(n for n, v in vars(ref_module).items()
                   if n.startswith("test_") and callable(v))
    assert set(skip) <= set(names), set(skip) - set(names)
    return [n for n in names if n not in skip]


def use_native(monkeypatch):
    """Build the port's native targets (a no-op when built) and make the
    codec and poll extensions the loaded planes for one test, whatever
    this process found built when it imported them."""

    _build.native()
    for mod in (TC, TPL):
        ext = _build.load_extension(mod.NAME)
        assert ext is not None, mod.NAME
        monkeypatch.setattr(mod, "lib", ext)


@pytest.fixture
def port_farm():
    f = TS.AgentFarm()
    yield f
    f.close()


POLL_CASES = reference_cases(REF_POLL, set())


@pytest.mark.parametrize("case", POLL_CASES)
def test_reference_poll_case_holds_on_the_port(case, port_farm, tmp_path,
                                               monkeypatch):
    if case == "test_native_engine_differential_vs_reference":
        use_native(monkeypatch)  # the case drives the engine itself
    run_on_port(REF_POLL, case, monkeypatch, farm=port_farm,
                tmp_path=tmp_path)


# -- crossed: each package's poller over the other's farm ----------------------

def _settled(farm):
    """The farm's byte counters once its loop has handled everything sent
    so far (a poll returns when the client holds its reply)."""

    done = threading.Event()
    farm.server.run_on_loop(done.set)
    assert done.wait(5.0)
    return farm.bytes_in, farm.bytes_out


def _row(s):
    """A sample's repr without its address (the farms' socket paths
    differ); the repr keeps value types apart (1 vs 1.0)."""

    return repr(dataclasses.replace(s, address=""))


def _build_farm(S, hosts, chips):
    farm = S.AgentFarm()
    sims = []
    for i in range(hosts):
        sim = S.SimAgent(support_sweep_frame=(i != 5))  # one old agent
        sim.values = S._bench_host_values(100 + i, chips, FIDS)
        sims.append(sim)
    addrs = [farm.add(s) for s in sims]
    farm.start()
    return farm, sims, addrs


def _step(E, sims, tick, chips):
    rng = random.Random(tick)
    for sim in sims:
        for _ in range(rng.randrange(0, 4)):
            c = rng.randrange(chips)
            if sim.values.get(c) is not None:
                sim.values[c][rng.choice(FIDS)] = rng.choice(
                    [None, rng.randrange(0, 9999),
                     round(rng.uniform(0.0, 700.0), 3)])
    if tick == 1:
        sims[3].events = [E.Event(etype=E.EventType.THERMAL,
                                  timestamp=1.5, seq=1, chip_index=0,
                                  uuid="u0", message="hot")]
    if tick == 2:
        sims[7].values[1] = None                       # chip lost
    if tick == 3:
        sims[7].values[1] = {f: 1.0 for f in FIDS}     # and back


def test_crossed_poller_and_farm():
    """The reference's poller reads the port's farm while the port's
    poller reads the reference's farm, both farms scripted alike."""

    hosts, chips = 16, 4
    farm_j, sims_j, addrs_j = _build_farm(JS, hosts, chips)
    farm_t, sims_t, addrs_t = _build_farm(TS, hosts, chips)
    ref = JP.FleetPoller(addrs_t, FIDS, timeout_s=5.0)   # over the port's
    port = TP.FleetPoller(addrs_j, FIDS, timeout_s=5.0)  # over the ref's
    try:
        before = [_settled(farm_t), _settled(farm_j)]
        for tick in range(5):
            _step(JE, sims_j, tick, chips)
            _step(TE, sims_t, tick, chips)
            a, b = ref.poll(), port.poll()
            assert all(s.up for s in a), (tick, a)
            assert [_row(s) for s in a] == [_row(s) for s in b], tick
            named = [[dataclasses.replace(s, address=str(i))
                      for i, s in enumerate(x)] for x in (a, b)]
            assert JCF.render(named[0]) == TCF.render(named[1]), tick
            # the bytes each farm counted on the wire, this tick
            after = [_settled(farm_t), _settled(farm_j)]
            moved = [(x[0] - y[0], x[1] - y[1])
                     for x, y in zip(after, before)]
            assert moved[0] == moved[1], (tick, moved)
            assert moved[0][0] > 0 and moved[0][1] > 0
            before = after
            assert (ref.tick_bytes_sent, ref.tick_bytes_recv) == \
                (port.tick_bytes_sent, port.tick_bytes_recv), tick
            assert [ref.per_host_tick_bytes()[x] for x in addrs_t] == \
                [port.per_host_tick_bytes()[x] for x in addrs_j], tick
            assert ref.last_changed_flags() == port.last_changed_flags()
        # the JSON pin and the event cursor, by the farms' own counters
        assert sims_j[5].sweep_frame_probes == \
            sims_t[5].sweep_frame_probes == 1
        assert sims_j[5].json_sweeps == sims_t[5].json_sweeps == 5
        assert a[3].events == b[3].events == 1
    finally:
        ref.close()
        port.close()
        farm_j.close()
        farm_t.close()


# -- both pollers over the port's agent ------------------------------------------

def test_both_pollers_read_the_port_agent_alike(tmp_path):
    sock = str(tmp_path / "a.sock")
    proc = spawn_agent(PORT_AGENT, sock, "--fake", "--fake-chips", "4",
                       "--fake-epoch", repr(FROZEN))
    addr = f"unix:{sock}"
    fields = FIDS + [int(TCF.F.DRIVER_VERSION), int(TCF.F.CHIP_UUID)]
    pj = JP.FleetPoller([addr], fields, timeout_s=5.0)
    pt = TP.FleetPoller([addr], fields, timeout_s=5.0)
    try:
        for _ in range(3):
            (a,), (b,) = pj.poll(), pt.poll()
            assert a.up and a.chips == 4, a
            assert repr(a) == repr(b)
            REF_POLL.assert_identical(pj.raw_snapshots()[addr],
                                      pt.raw_snapshots()[addr], "agent")
        assert pt.hello_rpcs_total == 1  # hello once per connection
        assert pt.last_changed_flags() == [False]  # index-only steady
    finally:
        pj.close()
        pt.close()
        stop_agent(proc)


# -- the CLI -----------------------------------------------------------------------

def _samples(P, seed):
    rng = random.Random(seed)
    out = []
    for i in range(6):
        if i == 4:
            out.append(P.HostSample(address=f"unix:/h{i}.sock", up=False,
                                    error="connect to unix:/h4.sock: "
                                          "ENOENT " + "x" * 80))
            continue
        out.append(P.HostSample(
            address=f"10.0.0.{i}:5555", up=True, chips=rng.choice([4, 8]),
            driver="580.159.03", power_w=rng.uniform(50.0, 5600.0),
            max_temp_c=rng.choice([None, rng.randrange(30, 90)]),
            mean_tc_util=rng.choice([None, rng.uniform(0, 100)]),
            mean_hbm_util=rng.choice([None, rng.uniform(0, 100)]),
            hbm_used_mib=rng.randrange(0, 650000),
            hbm_total_mib=655360, links_up=rng.randrange(0, 144),
            events=rng.randrange(0, 5), live_fields=rng.randrange(0, 56),
            dead_chips=rng.choice([0, 0, 1])))
    return out


@pytest.mark.parametrize("seed", range(3))
def test_render_and_check_render_equal_the_reference(seed):
    a, b = _samples(JP, seed), _samples(TP, seed)
    assert TCF.render(b) == JCF.render(a)
    for expect in (None, 4, 8):
        assert TCF.check_render(b, expect) == JCF.check_render(a, expect)
    assert TCF.render([]) == JCF.render([])


def _cli(pkg, args, env=None):
    return subprocess.run(
        [sys.executable, "-m", f"{pkg}.cli.fleet"] + args,
        capture_output=True, text=True, cwd=REPO, timeout=120,
        env=env or agent_env())


@pytest.fixture(scope="module")
def fake_agent(tmp_path_factory):
    sock = str(tmp_path_factory.mktemp("fleetcli") / "a.sock")
    proc = spawn_agent(PORT_AGENT, sock, "--fake", "--fake-chips", "4",
                       "--fake-epoch", repr(FROZEN))
    yield f"unix:{sock}"
    stop_agent(proc)


@pytest.mark.parametrize("args, rc, passes", [
    (["--once"], 0, 0),
    (["--once", "--check", "--expect-chips", "4"], 0, 1),
    (["--once", "--check", "--expect-chips", "8"], 1, 0),
    (["--once", "--check"], 0, 1),
    (["--once", "--check", "--connect", "unix:/nonexistent-fleet.sock",
      "--timeout", "1"], 1, 1),
    (["--once", "--expect-chips", "4"], 2, 0),
])
def test_once_check_exit_codes_match_the_reference(fake_agent, args, rc,
                                                    passes):
    argv = ["--connect", fake_agent] + args
    port, ref = _cli("tpumon_torch", argv), _cli("tpumon", argv)
    assert (port.returncode, ref.returncode) == (rc, rc), port.stderr
    assert port.stdout == ref.stdout
    assert port.stdout.count("[PASS]") == passes
    if rc == 2:
        assert "--expect-chips requires --check" in port.stderr
    elif "--check" not in args:
        assert "SLICE (1/1 up)" in port.stdout


def test_no_targets_exits_like_the_reference():
    port, ref = _cli("tpumon_torch", ["--once"]), _cli("tpumon", ["--once"])
    assert port.returncode == ref.returncode != 0
    assert "no targets" in port.stderr


# -- plane selection -------------------------------------------------------------

def test_native_selection_gives_the_engine_poller(monkeypatch, fake_agent):
    """``native=True`` and ``TPUMON_NATIVE=1`` build a
    ``NativeFleetPoller``, ``TPUMON_NATIVE=0`` and ``native=False`` the
    Python poller; both read the agent alike, and the fleet CLI answers
    with the same bytes on either plane."""

    use_native(monkeypatch)
    assert TP.poll_native_available()
    made = []
    try:
        made.append(TP.create_fleet_poller([fake_agent], FIDS, native=True,
                                           timeout_s=5.0))
        monkeypatch.setenv("TPUMON_NATIVE", "1")
        assert TP.poll_native_selected()
        made.append(TP.create_fleet_poller([fake_agent], FIDS,
                                           timeout_s=5.0))
        monkeypatch.setenv("TPUMON_NATIVE", "0")
        assert not TP.poll_native_selected()
        made.append(TP.create_fleet_poller([fake_agent], FIDS,
                                           timeout_s=5.0))
        made.append(TP.create_fleet_poller([fake_agent], FIDS, native=False,
                                           timeout_s=5.0))
        assert [type(p) for p in made] == [TP.NativeFleetPoller] * 2 + \
            [TP.FleetPoller] * 2
        rows = [repr(p.poll()[0]) for p in made]
        assert rows[0] == rows[1] == rows[2] == rows[3]
        assert "up=True" in rows[0]
    finally:
        for p in made:
            p.close()
    out = [_cli("tpumon_torch", ["--connect", fake_agent, "--once"],
                env=agent_env(TPUMON_NATIVE=v)) for v in ("1", "0")]
    assert [r.returncode for r in out] == [0, 0], out[0].stderr
    assert out[0].stdout == out[1].stdout


# -- imports ---------------------------------------------------------------------------

def test_fleet_modules_import_neither_tpumon_jax_nor_torch():
    r = subprocess.run(
        [sys.executable, "-c",
         "import sys, tpumon_torch.fleetpoll, tpumon_torch.fleetshard, "
         "tpumon_torch.supervisor, tpumon_torch.cli.fleet, "
         "tpumon_torch.agentsim; print(sorted(m for m in sys.modules "
         "if m.split('.')[0] in ('tpumon', 'jax', 'jaxlib', 'torch')))"],
        capture_output=True, text=True, cwd=REPO, timeout=60,
        env=agent_env())
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "[]"
