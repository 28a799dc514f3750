"""Gloo ranks for the port's multi-device tests: a pool of processes that
join one process group and run, on command, the case functions below.

No test lives here.  ``tests/test_torch_ring.py`` and
``tests/test_torch_collectives.py`` spawn one :class:`RankPool` per world
size for their whole module (a module-scoped fixture) and run every case
in it: each case is one round trip, the same numpy inputs pickled to every
rank, each rank's result pickled back.  The ranks import torch and the
port, never JAX.  Run by hand::

    pool = RankPool(4, tmp_dir)
    outs = pool.run("ring_case", q, k, v, True)   # one result per rank
    pool.close()
"""

import os
import pickle
import select
import struct
import subprocess
import sys
import time

import numpy as np

TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)


# ---- the pool (test process side) ------------------------------------------------

def _send(f, obj) -> None:
    data = pickle.dumps(obj)
    f.write(struct.pack("<Q", len(data)) + data)
    f.flush()


def _read_exact(fd: int, n: int, deadline: float) -> bytes:
    buf = b""
    while len(buf) < n:
        left = deadline - time.monotonic()
        if left <= 0 or not select.select([fd], [], [], left)[0]:
            raise TimeoutError("rank did not answer in time")
        chunk = os.read(fd, n - len(buf))
        if not chunk:
            raise EOFError("rank exited")
        buf += chunk
    return buf


class RankPool:
    """``world`` gloo ranks (a file store under ``tmp_dir``), each with one
    torch thread, waiting for cases."""

    def __init__(self, world: int, tmp_dir: str) -> None:
        self.world = world
        store = os.path.join(str(tmp_dir), f"store{world}")
        env = dict(os.environ, PYTHONPATH=os.pathsep.join([REPO, TESTS]),
                   OMP_NUM_THREADS="1")
        self.procs = [subprocess.Popen(
            [sys.executable, "-c",
             f"import test_torch_ranks as R; R.serve({r}, {world}, "
             f"{store!r})"],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, cwd=REPO,
            env=env) for r in range(world)]

    def run(self, case: str, *args, timeout_s: float = 300.0) -> list:
        """``case(*args)`` on every rank -> their results, in rank order;
        a case that raised on any rank raises here with its traceback."""

        for p in self.procs:
            _send(p.stdin, (case, args))
        deadline = time.monotonic() + timeout_s
        out = []
        for r, p in enumerate(self.procs):
            fd = p.stdout.fileno()
            (n,) = struct.unpack("<Q", _read_exact(fd, 8, deadline))
            ok, val = pickle.loads(_read_exact(fd, n, deadline))
            if not ok:
                raise AssertionError(f"rank {r} of {self.world}: {val}")
            out.append(val)
        return out

    def close(self) -> None:
        for p in self.procs:
            try:
                p.stdin.close()
            except OSError:
                pass
        for p in self.procs:
            try:
                p.wait(timeout=30)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
            p.stdout.close()


# ---- the ranks (child side) ------------------------------------------------------

def serve(rank: int, world: int, store: str) -> None:
    import traceback

    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    inp, out = sys.stdin.buffer, sys.stdout.buffer
    try:
        while True:
            head = inp.read(8)
            if len(head) < 8:
                break
            (n,) = struct.unpack("<Q", head)
            case, args = pickle.loads(inp.read(n))
            try:
                reply = (True, globals()[case](*args))
            except Exception:  # reported to the test process, which fails
                reply = (False, traceback.format_exc())
            _send(out, reply)
    finally:
        dist.destroy_process_group()


def _t(a):
    import torch

    return torch.from_numpy(np.ascontiguousarray(a))


def _np(t):
    return t.detach().float().numpy()


def ring_case(q, k, v, causal, n=None):
    """This rank's shard of ring attention over the first ``n`` ranks
    (None on a rank outside them)."""

    from tpumon_torch.loadgen import ring as R

    mesh = R.make_seq_mesh(n)
    if mesh.rank < 0:
        return None
    shard = [_t(x).chunk(mesh.size, dim=1)[mesh.rank] for x in (q, k, v)]
    return _np(R.ring_attention(*shard, mesh, causal=causal))


def allreduce_case(mb):
    from tpumon_torch.loadgen import ring as R

    step, state = R.ring_allreduce_load(R.make_seq_mesh(axis="data"),
                                        mb_per_device=mb, device="cpu")
    shape = tuple(state.shape)
    s1 = step(state)
    first = _np(s1[:4])
    s2 = step(s1)
    return first, shape, tuple(s2.shape)


def dcn_case(x_global, n_slices, chips):
    """Ones through one step, then this rank's shard of a random global
    buffer through one step."""

    from tpumon_torch.loadgen import ring as R

    ms = R.make_multislice_mesh(n_slices, chips)
    step, state = R.dcn_allreduce_load(ms, mb_per_device=1, device="cpu")
    ones = _np(step(state)[:4])
    import torch.distributed as dist

    per = x_global.shape[0] // dist.get_world_size()
    mine = _t(x_global[dist.get_rank() * per:(dist.get_rank() + 1) * per])
    return ones, _np(step(mine.clone()))


def multislice_shapes(n_slices):
    from tpumon_torch.loadgen import ring as R

    ms = R.make_multislice_mesh(n_slices)
    return ms.n_slices, ms.chips, ms.chip.size, ms.slice.size


def multislice_refusal(n_slices):
    from tpumon_torch.loadgen import ring as R

    try:
        R.make_multislice_mesh(n_slices)
    except ValueError as e:
        return str(e)
    return None


def pattern_steps(seq, heads, head_dim):
    from tpumon_torch.loadgen import ring as R

    step, state = R.make_ring_attention_pattern(
        seq_per_device=seq, heads=heads, head_dim=head_dim, device="cpu")
    s2 = step(step(state))
    return [tuple(t.shape) for t in s2]


def pipeline_case(x, w, n=None):
    from tpumon_torch.loadgen import parallel as PP
    from tpumon_torch.loadgen import ring as R

    mesh = R.make_seq_mesh(n, axis="stage")
    if mesh.rank < 0:
        return None
    return _np(PP.pipeline_forward(_t(x), _t(w[mesh.rank]), mesh))


def moe_case(x_global, w):
    from tpumon_torch.loadgen import parallel as PP
    from tpumon_torch.loadgen import ring as R

    mesh = R.make_seq_mesh(axis="expert")
    x = _t(x_global).chunk(mesh.size, dim=0)[mesh.rank]
    return _np(PP.moe_forward(x, _t(w[mesh.rank]), mesh))


def loads_bounded():
    """Three steps of each parallel load at test widths: this rank's state
    after them."""

    from tpumon_torch.loadgen import parallel as PP

    out = {}
    step, state = PP.pipeline_load(d=32, batch=2, device="cpu")
    for _ in range(3):
        state = step(state)
    out["pp"] = _np(state)
    step, state = PP.moe_alltoall_load(d=32, tokens_per_device=16,
                                       device="cpu")
    for _ in range(3):
        state = step(state)
    out["moe"] = _np(state)
    return out


def attributed_steps(pattern, world_slices):
    """One step of a multi-device load pattern (at test widths) under a
    CPU profiler session with shapes -> (the port's attributed collectives,
    what the backend recorded), for ``tests/test_torch_collectives.py``."""

    import torch
    from torch.profiler import ProfilerActivity, profile

    from tpumon_torch import collectives as C
    from tpumon_torch.loadgen import parallel as PP
    from tpumon_torch.loadgen import ring as R

    if pattern == "allreduce":
        step, state = R.ring_allreduce_load(R.make_seq_mesh(axis="data"),
                                            mb_per_device=1, device="cpu")
    elif pattern == "dcn":
        step, state = R.dcn_allreduce_load(
            R.make_multislice_mesh(world_slices), mb_per_device=1,
            device="cpu")
    elif pattern == "pp":
        step, state = PP.pipeline_load(d=32, batch=2, device="cpu")
    elif pattern == "moe":
        step, state = PP.moe_alltoall_load(d=32, tokens_per_device=16,
                                           device="cpu")
    else:
        step, state = R.make_ring_attention_pattern(
            seq_per_device=16, heads=2, head_dim=8, device="cpu")
    state = step(state)  # warm: groups built, buffers allocated
    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU],
                                  record_shapes=True) as prof:
        step(state)
    events = prof.profiler.kineto_results.events()
    recs = C.comm_records(events)
    seen = [(e.name(), [list(d) for d in e.shapes()], list(e.dtypes()))
            for e in events if e.name().startswith("gloo:")]
    return [tuple(r) for r in recs], seen


# ---- the sharded model (tests/test_torch_sharded.py) -----------------------------

def _np_tree(tree):
    from tpumon_torch.loadgen import model as M

    return M.tree_map(_np, tree)


def mesh_case(n):
    """``make_mesh(n)``: (shape, data ranks, model ranks), None on a rank
    outside the mesh."""

    from tpumon_torch.loadgen import model as M

    mesh = M.make_mesh(n)
    if mesh.model.rank < 0:
        return None
    return mesh.shape, mesh.data.ranks, mesh.model.ranks


def shard_case(np_params, tokens, n):
    """This rank's shards of ``np_params`` (``params_from_jax`` with the
    mesh) and of ``tokens`` (``batch_spec``), exactly as held."""

    from tpumon_torch.loadgen import model as M

    mesh = M.make_mesh(n)
    shards = M.params_from_jax(np_params, device="cpu", mesh=mesh)
    return (M.tree_map(lambda t: t.numpy(), shards),
            M.shard(_t(tokens), M.batch_spec(), mesh).numpy())


def sharded_layer_case(np_layer, x, flash, n):
    """One f32 layer on this rank's shards of ``np_layer`` (one layer of
    the stacked leaves) over its data rows of ``x``: its output rows."""

    import dataclasses

    from tpumon_torch.loadgen import model as M

    cfg = dataclasses.replace(M.ModelConfig.tiny(), flash=flash)
    mesh = M.make_mesh(n)
    specs = M.param_specs()["layers"]
    layer = {k: M.shard(_t(v), specs[k][1:], mesh)
             for k, v in np_layer.items()}
    rows = M.shard(_t(x), M.batch_spec() + (None,), mesh)
    return _np(M._layer(cfg, rows, layer, mesh.model))


def _gather_fault():
    """A ``gather_from`` whose backward sums the gradient over the group
    (a reduce-scatter) instead of keeping this rank's block."""

    import torch

    from tpumon_torch.loadgen import model as M

    class SummingGather(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, g):
            ctx.g = g
            return M._gather(x, -1, g)

        @staticmethod
        def backward(ctx, dy):
            return M._own_block(M._all_reduce(dy, ctx.g), ctx.g), None

    return lambda x, g: SummingGather.apply(x, g)


def sharded_step_case(np_params, tokens, flash, n, fault=False):
    """One ``sharded_train_step`` over ``make_mesh(n)`` from this rank's
    shards of ``np_params`` and rows of ``tokens`` -> (loss, the updated
    parameters gathered whole).  ``fault``: with :func:`_gather_fault`
    in place of ``gather_from``."""

    import dataclasses

    from tpumon_torch.loadgen import model as M

    cfg = dataclasses.replace(M.ModelConfig.tiny(), flash=flash)
    mesh = M.make_mesh(n)
    if mesh.model.rank < 0:
        return None
    params = M.params_from_jax(np_params, device="cpu", mesh=mesh)
    rows = M.shard(_t(tokens), M.batch_spec(), mesh)
    saved = M.gather_from
    if fault:
        M.gather_from = _gather_fault()
    try:
        params, loss = M.sharded_train_step(cfg, mesh)(params, rows)
    finally:
        M.gather_from = saved
    return loss.item(), _np_tree(M.gather_params(params, mesh))


def unsharded_equal_case(np_params, tokens, flash):
    """``sharded_train_step`` over ``make_mesh(1)`` against ``train_step``
    from the same parameters: (losses equal, every parameter equal), bit
    for bit; None on a rank outside the mesh."""

    import dataclasses

    import torch

    from tpumon_torch.loadgen import model as M

    cfg = dataclasses.replace(M.ModelConfig.tiny(), flash=flash)
    mesh = M.make_mesh(1)
    if mesh.model.rank < 0:
        return None
    whole = M.params_from_jax(np_params, device="cpu")
    shards = M.params_from_jax(np_params, device="cpu", mesh=mesh)
    whole, l1 = M.train_step(cfg, whole, _t(tokens))
    shards, l2 = M.sharded_train_step(cfg, mesh)(shards, _t(tokens))
    return (torch.equal(l1, l2),
            all(torch.equal(a, b) for a, b in zip(
                M.tree_leaves(whole), M.tree_leaves(shards))))


def sharded_attribution_case(np_params, tokens):
    """One ``sharded_train_step`` over ``make_mesh()`` under a CPU
    profiler session with shapes, after a warm step -> (every attributed
    collective, the ones inside the gradient sync's span, the bytes of
    this rank's gradient shards, the collectives gloo recorded)."""

    import torch
    from torch.profiler import ProfilerActivity, profile

    from tpumon_torch import collectives as C
    from tpumon_torch.loadgen import model as M

    cfg = M.ModelConfig.tiny()
    mesh = M.make_mesh()
    params = M.params_from_jax(np_params, device="cpu", mesh=mesh)
    rows = M.shard(_t(tokens), M.batch_spec(), mesh)
    step = M.sharded_train_step(cfg, mesh)
    params, _ = step(params, rows)
    with profile(activities=[ProfilerActivity.CPU],
                 record_shapes=True) as prof:
        step(params, rows)
    events = prof.profiler.kineto_results.events()
    recs = C.comm_records(events)
    (span,) = [(e.start_ns(), e.start_ns() + e.duration_ns())
               for e in events if e.name() == M.GRAD_SYNC_SPAN]
    sync = [r for r in recs if span[0] <= r.start_ns <= span[1]]
    shard_bytes = [t.numel() * t.element_size()
                   for t in M.tree_leaves(params) if t.is_floating_point()]
    seen = [e.name() for e in events if e.name().startswith("gloo:")]
    return ([tuple(r) for r in recs], [tuple(r) for r in sync], shard_bytes,
            seen, torch.distributed.get_world_size())


def dryrun_check(name):
    """One of the dry run's per-rank checks (``tpumon_torch.entry``) over
    every rank of the pool -> what it returns."""

    import torch
    import torch.distributed as dist

    from tpumon_torch import entry as E

    fn = getattr(E, name)
    if name == "check_modeled_links":
        return fn()
    return fn(dist.get_world_size(), torch.device("cpu"))
