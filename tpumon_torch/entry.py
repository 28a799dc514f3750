"""Harness entry points of the port: the counterpart of the JAX package's
``__graft_entry__.py``.

``entry()`` returns the forward step of the flagship workload (the
load-generator transformer, :mod:`tpumon_torch.loadgen.model`) at its
``tiny`` shapes, with example arguments.

``dryrun_multichip(n)`` runs the multi-device paths once on ``n`` ranks
and checks each against its oracle.  The reference runs one controller
over ``n`` virtual devices; torch runs one process per rank, so this
spawns ``n`` rank processes (gloo on the CPU; NCCL on the card, one card a
rank) that each run :func:`_dryrun_rank`, the reference's checks in its
order:

1. the dp x tp sharded train step (:func:`check_sharded_step`);
2. ring attention against the dense oracle (:func:`check_ring_attention`);
3. the all-reduce load's attributed wire bytes against the ring bound
   (:func:`check_allreduce_bytes`);
4. a group over a permuted rank list keeps its order (n >= 4,
   :func:`check_participant_order`);
5. the multi-slice sync's ICI/DCN split against the ring bound of what
   the backend ran (n >= 2, :func:`check_multislice_split`);
6. the exporter's modeled per-link split keeps each chip's aggregate
   (:func:`check_modeled_links`);
7. the pipeline against its sequential oracle (:func:`check_pipeline`);
8. MoE's all-to-all against its dense oracle (:func:`check_moe`).

On the CPU::

    python -c "from tpumon_torch.entry import dryrun_multichip; \\
dryrun_multichip(4, device='cpu')"
"""

from __future__ import annotations

import functools
import os
import socket
import subprocess
import sys
import tempfile
import time

import torch
import torch.distributed as dist

from .loadgen import model as M
from .loadgen import parallel as PP
from .loadgen import ring as R

#: the all-reduce load's per-rank buffer (``mb_per_device=1``, f32)
SHARD_BYTES = 1024 * 1024
#: how long the ranks of a dry run may take, s
DRYRUN_TIMEOUT_S = 600.0
#: the rank process's program
_RANK_MAIN = ("import sys; from tpumon_torch.entry import _rank_main; "
              "_rank_main(*sys.argv[1:])")


def _device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device (pass device='cpu' to run on "
                           "the CPU)")
    return dev


def entry(device="cuda"):
    """``(fn, (params, tokens))``: ``fn(params, tokens)`` is the model's
    forward at ``ModelConfig.tiny()``, tokens (4, seq_len), the tensors on
    ``device``."""

    dev = _device(device)
    cfg = M.ModelConfig.tiny()
    params = M.init_params(torch.Generator(dev).manual_seed(0), cfg)
    tokens = torch.randint(0, cfg.vocab, (4, cfg.seq_len), device=dev,
                           generator=torch.Generator(dev).manual_seed(1))
    return functools.partial(M.forward, cfg), (params, tokens)


# ---- the checks, run on every rank -------------------------------------------

def _check(ok: bool, msg: str) -> None:
    if not ok:
        raise AssertionError(msg)


def _randn(shape, seed: int) -> torch.Tensor:
    """A normal tensor drawn from ``seed``: the same on every rank."""

    return torch.randn(shape, generator=torch.Generator().manual_seed(seed))


def _captured(fn, device: torch.device):
    """``fn()`` under a profiler session recording shapes -> the
    collectives it ran, attributed (:func:`tpumon_torch.collectives.
    comm_records`)."""

    from torch.profiler import ProfilerActivity, profile

    from . import collectives as C
    from . import trace as T

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with T.profiler_session(), torch.no_grad(), \
            profile(activities=acts, record_shapes=True) as prof:
        fn()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    return C.comm_records(prof.profiler.kineto_results.events())


def check_sharded_step(n: int, device: torch.device) -> float:
    """One sharded train step at ``tiny`` over ``make_mesh(n)``, batch
    ``max(dp * 2, 4)``: a finite loss (returned)."""

    cfg = M.ModelConfig.tiny()
    mesh = M.make_mesh(n)
    dp = mesh.shape[0]
    params = M.tree_map(lambda t: t.to(device), M.init_params(
        torch.Generator().manual_seed(0), cfg))
    tokens = torch.randint(0, cfg.vocab, (max(dp * 2, 4), cfg.seq_len),
                           generator=torch.Generator().manual_seed(1))
    step = M.sharded_train_step(cfg, mesh)
    _, loss = step(M.shard_params(params, mesh),
                   M.shard(tokens, M.batch_spec(), mesh).to(device))
    _check(bool(torch.isfinite(loss)), f"non-finite loss {loss.item()}")
    return loss.item()


def check_ring_attention(n: int, device: torch.device) -> None:
    """Ring attention over n ranks at (1, 8n, 2, 8) f32 against
    ``ring_attention_reference``, within 2e-5."""

    mesh = R.make_seq_mesh(n)
    q, k, v = (_randn((1, 8 * n, 2, 8), seed) for seed in (21, 22, 23))
    mine = [x.chunk(n, dim=1)[mesh.rank].contiguous().to(device)
            for x in (q, k, v)]
    got = R.ring_attention(*mine, mesh).cpu()
    want = R.ring_attention_reference(q, k, v).chunk(n, dim=1)[mesh.rank]
    _check(torch.allclose(got, want, rtol=2e-5, atol=2e-5),
           "ring attention diverged from the dense oracle")


def check_allreduce_bytes(n: int, device: torch.device) -> int:
    """One ``ring_allreduce_load(mb_per_device=1)`` step under a profiler
    session: its attributed wire bytes equal the ring bound
    ``2 * S * (n - 1) / n`` for S = 1 MiB (0 at one rank), and are > 0
    when n > 1.  Returns them."""

    step, state = R.ring_allreduce_load(R.make_seq_mesh(n, axis="data"),
                                        mb_per_device=1, device=device)
    recs = _captured(lambda: step(state), device)
    wire = sum(r.wire for r in recs)
    want = int(2 * SHARD_BYTES * (n - 1) / n)
    _check(bool(recs), "the all-reduce was not attributed")
    _check(wire == want, f"attributed {wire} B != ring bound {want} B on "
                         f"{n} ranks")
    _check(n == 1 or wire > 0, "no attributed bytes under the all-reduce")
    return wire


def permuted_ranks(n: int) -> list:
    """The reference's permuted device order: reversed, first two
    swapped (not a plain reversal)."""

    perm = list(reversed(range(n)))
    perm[0], perm[1] = perm[1], perm[0]
    return perm


def check_participant_order(n: int, device: torch.device) -> dict:
    """A 1D group over :func:`permuted_ranks`: ``Group1D.ranks`` keeps the
    permuted order (``dist.new_group`` sorts its own), and a ring shift
    over it sends to the permuted neighbour.  Returns what was seen."""

    perm = permuted_ranks(n)
    g = R._group1d(perm, "d")
    me = dist.get_rank()
    _check(g.ranks == tuple(perm), f"group ranks {g.ranks} != {perm}")
    _check(g.ranks[g.rank] == me, "group position does not hold this rank")
    (got,) = g.shift(torch.full((1,), float(me), device=device))
    want = perm[(g.rank - 1) % n]
    _check(int(got.item()) == want,
           f"rank {me} got rank {int(got.item())}'s block, want the "
           f"permuted neighbour {want}'s")
    return {"ranks": list(g.ranks),
            "backend_ranks": dist.get_process_group_ranks(g.group),
            "from": int(got.item())}


def multislice_bound(n_slices: int, chips: int, backend: str):
    """(ici, dcn) bytes a rank moves in one ``dcn_allreduce_load``
    (``mb_per_device=1``) step: the ring bound of what ``backend`` runs.
    gloo runs the reduce-scatter as an all-reduce of its whole input."""

    from . import collectives as C

    n_elem = SHARD_BYTES // 4
    shard = (n_elem - n_elem % chips) * 4
    rs = C.wire_bytes("allreduce" if backend == "gloo" else "scatter",
                      shard, chips)
    return (rs + C.wire_bytes("gather", shard, chips),
            C.wire_bytes("allreduce", shard // chips, n_slices))


def check_multislice_split(n: int, device: torch.device) -> tuple:
    """``dcn_allreduce_load`` over ``make_multislice_mesh(2, n // 2)``
    under a profiler session: ``split_bytes`` equals
    :func:`multislice_bound` for this backend, with DCN bytes > 0 (and
    ICI bytes > 0 when a slice has more than one chip)."""

    from . import collectives as C

    chips = n // 2
    ms = R.make_multislice_mesh(2, chips)
    step, state = R.dcn_allreduce_load(ms, mb_per_device=1, device=device)
    got = C.split_bytes(_captured(lambda: step(state), device))
    want = multislice_bound(2, chips, dist.get_backend())
    _check(got == want, f"ICI/DCN split {got} != ring bound {want}")
    _check(got[1] > 0 and (chips == 1 or got[0] > 0),
           f"no measured bytes in the split {got}")
    return got


def check_modeled_links() -> dict:
    """The fake backend at 8 chips with the per-link ICI fields blanked,
    and its exporter with ``ici_per_link_modeled``: every chip's modeled
    links, each labeled ``source="modeled"``, sum to its aggregate within
    0.5.  Returns the per-chip sums."""

    import tpumon_torch

    from . import fields as TF
    from .backends.fake import FakeBackend, FakeSliceConfig
    from .exporter.exporter import TpuExporter

    fb = FakeBackend(config=FakeSliceConfig(num_chips=8))
    fb.set_blank_fields(TF.PER_LINK_ICI_FIELDS)
    h = tpumon_torch.init(backend=fb)
    try:
        exp = TpuExporter(h, interval_ms=1000, output_path=None,
                          ici_per_link_modeled=True)
        try:
            text = exp.sweep()
        finally:
            exp.stop()
    finally:
        tpumon_torch.shutdown()
    agg, modeled = {}, {}
    for ln in text.splitlines():
        if ln.startswith("tpu_ici_tx_throughput{"):
            chip = ln.split('chip="')[1].split('"')[0]
            agg[chip] = float(ln.rsplit(" ", 1)[1])
        elif ln.startswith("tpu_ici_link_tx_throughput{"):
            _check('source="modeled"' in ln,
                   "a modeled per-link sample is not labeled")
            chip = ln.split('chip="')[1].split('"')[0]
            modeled[chip] = modeled.get(chip, 0.0) + \
                float(ln.rsplit(" ", 1)[1])
    _check(bool(modeled) and set(modeled) == set(agg),
           f"modeled chips {sorted(modeled)} != {sorted(agg)}")
    for chip, total in modeled.items():
        _check(abs(total - agg[chip]) < 0.5,
               f"modeled split lost bytes on chip {chip}: {total} vs "
               f"{agg[chip]}")
    return modeled


def check_pipeline(n: int, device: torch.device) -> None:
    """``pipeline_forward`` over n stages (d 16, n + 1 microbatches of 2)
    against ``pipeline_reference``, within 1e-4."""

    mesh = R.make_seq_mesh(n, axis="stage")
    d = 16
    w = _randn((n, d, d), 3) / d ** 0.5
    xs = _randn((n + 1, 2, d), 4)
    got = PP.pipeline_forward(xs.to(device), w[mesh.rank].to(device),
                              mesh).cpu()
    _check(torch.allclose(got, PP.pipeline_reference(xs, w), rtol=1e-4,
                          atol=1e-4),
           "pipeline diverged from the sequential oracle")


def check_moe(n: int, device: torch.device) -> None:
    """``moe_forward`` over n experts (d 16, 2n^2 tokens) against
    ``moe_reference``, within 1e-4."""

    mesh = R.make_seq_mesh(n, axis="expert")
    d = 16
    w = _randn((n, d, d), 5) / d ** 0.5
    x = _randn((n * n * 2, d), 6)
    got = PP.moe_forward(x.chunk(n)[mesh.rank].to(device),
                         w[mesh.rank].to(device), mesh).cpu()
    want = PP.moe_reference(x, w, n).chunk(n)[mesh.rank]
    _check(torch.allclose(got, want, rtol=1e-4, atol=1e-4),
           "moe all-to-all diverged from the dense oracle")


def _dryrun_rank(n: int, device: torch.device) -> None:
    """The dry run's checks on this rank of an n-rank process group."""

    check_sharded_step(n, device)
    check_ring_attention(n, device)
    check_allreduce_bytes(n, device)
    if n >= 4:
        check_participant_order(n, device)
    if n >= 2:
        check_multislice_split(n, device)
    check_modeled_links()
    check_pipeline(n, device)
    check_moe(n, device)


def _rank_main(rank: str, world: str, device: str, coordinator: str) -> None:
    """A rank process: join the group, run the checks, leave."""

    dev = torch.device(device)
    if dev.type == "cpu":
        torch.set_num_threads(1)
    dev = R.init_process_group(dev, coordinator, int(world), int(rank))
    try:
        _dryrun_rank(int(world), dev)
    finally:
        dist.destroy_process_group()


# ---- the dry run --------------------------------------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def dryrun_multichip(n_devices: int, device="cuda") -> None:
    """Run :func:`_dryrun_rank` on ``n_devices`` rank processes: gloo on
    the CPU, NCCL on ``cuda`` (one card a rank: more ranks than cards
    raises before any starts).  Raises with the first failing rank's
    traceback, or when the ranks outlast ``DRYRUN_TIMEOUT_S``."""

    dev = _device(device)
    if dev.type == "cuda":
        R.refuse_beyond_cards(n_devices)
    pkg_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [pkg_root] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    if dev.type == "cpu":
        env["OMP_NUM_THREADS"] = "1"
    coordinator = f"127.0.0.1:{_free_port()}"
    logs = [tempfile.TemporaryFile() for _ in range(n_devices)]
    procs = []
    try:
        for r in range(n_devices):
            procs.append(subprocess.Popen(
                [sys.executable, "-c", _RANK_MAIN, str(r), str(n_devices),
                 dev.type, coordinator], stdin=subprocess.DEVNULL,
                stdout=subprocess.DEVNULL, stderr=logs[r], env=env))
        deadline = time.monotonic() + DRYRUN_TIMEOUT_S
        while True:
            codes = [p.poll() for p in procs]
            # the first rank to fail: the others may fail after it,
            # waiting on it in a collective
            bad = next((r for r, c in enumerate(codes) if c), None)
            if bad is not None:
                logs[bad].seek(0)
                err = logs[bad].read().decode(errors="replace")
                raise RuntimeError(f"dry run failed on rank {bad} of "
                                   f"{n_devices} (exit {codes[bad]}):\n"
                                   f"{err[-6000:]}")
            if all(c == 0 for c in codes):
                return
            if time.monotonic() > deadline:
                raise TimeoutError(f"dry run on {n_devices} ranks outlasted "
                                   f"{DRYRUN_TIMEOUT_S} s")
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for f in logs:
            f.close()
