"""Pipeline- and expert-parallel load patterns (pp / ep).

Counterpart of ``tpumon/loadgen/parallel.py`` over ``torch.distributed``,
one process per rank as in :mod:`.ring` (each function runs on every rank
of the group and takes its shard):

* :func:`pipeline_load` — a GPipe-style stage pipeline over a 1D
  "stage" group: activations hop stage to stage every tick by P2P
  (``batch_isend_irecv``), with the fill/drain bubble of a real schedule,
  and the finished microbatches return to stage 0 over the wrap link by
  one send/recv.
* :func:`moe_alltoall_load` — expert parallelism: tokens go to their
  expert's rank by ``all_to_all_single``, one expert matmul, and the
  return ``all_to_all_single``.

Both are linear, so they have exact dense oracles (:func:`pipeline_reference`,
:func:`moe_reference`), and value-preserving enough (weights with unit
columns, outputs renormalised) to loop forever.  The reference's
``lax.scan`` carries become Python loops; a 1-rank group makes every hop
the identity (no P2P is issued) and runs as a plain matmul loop.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from .ring import Group1D, make_seq_mesh, seeded_shard

__all__ = [
    "make_seq_mesh", "pipeline_forward", "pipeline_load",
    "pipeline_reference", "moe_forward", "moe_alltoall_load",
    "moe_reference",
]


def _stage_weights(seed: int, n: int, d: int) -> torch.Tensor:
    """(n, d, d) bf16 weights whose columns have unit norm, so repeated
    application stays bounded (``x @ w`` keeps scale in expectation)."""

    g = torch.Generator("cpu").manual_seed(seed)
    w = torch.randn((n, d, d), generator=g)
    return (w / torch.linalg.norm(w, dim=1, keepdim=True)).to(torch.bfloat16)


# -- pipeline parallelism ------------------------------------------------------


def _pipeline_scan(x_in: torch.Tensor, w0: torch.Tensor,
                   mesh: Group1D) -> torch.Tensor:
    """This rank's pipeline schedule: M + n - 1 ticks.

    Each tick every stage multiplies its resident activation by its
    weight and hands the result to the next stage (a cyclic neighbour
    hop); stage 0 injects microbatch ``t`` while the tail stages drain
    earlier ones.  Returns the (M, B, D) float32 output buffer, filled on
    the LAST stage only."""

    n, my = mesh.size, mesh.rank
    M = x_in.shape[0]
    buf = torch.zeros(x_in.shape[1:], dtype=x_in.dtype, device=x_in.device)
    out = torch.zeros(x_in.shape, dtype=torch.float32, device=x_in.device)
    for t in range(M + n - 1):
        if my == 0:
            cur = x_in[t] if t < M else torch.zeros_like(buf)
        else:
            cur = buf
        y = (cur @ w0).to(x_in.dtype)
        (buf,) = mesh.shift(y)
        # the LAST stage's product of this tick is microbatch t-(n-1)
        if my == n - 1 and t >= n - 1:
            out[t - (n - 1)] = y.float()
    return out


def pipeline_forward(x: torch.Tensor, w: torch.Tensor,
                     mesh: Group1D) -> torch.Tensor:
    """Run microbatches through an n-stage linear pipeline.

    ``x``: (M, B, D) microbatches, the same on every rank.  ``w``: this
    rank's (D, D) stage weight.  Returns the (M, B, D) outputs on every
    rank, equal to ``x[m] @ w_0 @ ... @ w_{n-1}``: the last stage's
    buffer replicated by an all-reduce of ``out * (my == n - 1)``, as the
    reference replicates it with a psum."""

    out = _pipeline_scan(x, w, mesh)
    out = out * float(mesh.rank == mesh.size - 1)
    with mesh.scope():
        dist.all_reduce(out, group=mesh.group)
    return out.to(x.dtype)


def pipeline_reference(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Dense oracle: sequential application of every stage weight."""

    out = x.float()
    for s in range(w.shape[0]):
        out = out @ w[s].float()
    return out.to(x.dtype)


def _wrap_hop(out: torch.Tensor, mesh: Group1D) -> torch.Tensor:
    """The last stage's tensor to stage 0 over the wrap link (one
    send/recv); every other rank gets zeros, as a partial ``ppermute``
    gives them.  The identity on a 1-stage group."""

    n, my = mesh.size, mesh.rank
    if n == 1:
        return out
    ret = torch.zeros_like(out)
    with mesh.scope():
        if my == n - 1:
            dist.send(out, mesh.ranks[0], group=mesh.group)
        elif my == 0:
            dist.recv(ret, mesh.ranks[n - 1], group=mesh.group)
    return ret


def pipeline_load(mesh: Optional[Group1D] = None, axis: str = "stage",
                  d: int = 1024, batch: int = 8,
                  n_micro: Optional[int] = None, device="cuda"):
    """(step_fn, state) for the loadgen: repeated pipeline passes.

    The state is stage-sharded: each rank holds (M, B, D), and stage 0's
    rows carry the live microbatches.  The finished outputs return to
    stage 0 over the wrap link (one neighbour hop, not an all-reduce), so
    the step's traffic is point-to-point only, and feed back as the next
    step's microbatches, renormalised by each rank's own RMS."""

    if mesh is None:
        mesh = make_seq_mesh(axis=axis)
    n = mesh.size
    if n_micro is None:
        n_micro = 2 * n
    w0 = _stage_weights(11, n, d)[mesh.rank].to(device)
    x = seeded_shard((n * n_micro, batch, d), 12, mesh, 0, device)

    def step(x_blk: torch.Tensor) -> torch.Tensor:
        ret = _wrap_hop(_pipeline_scan(x_blk, w0, mesh), mesh)
        scale = torch.sqrt(ret.square().mean() + 1e-6)
        return (ret / scale).to(x_blk.dtype)

    return step, x


# -- expert parallelism (MoE all-to-all) ---------------------------------------


def moe_forward(x: torch.Tensor, w: torch.Tensor,
                mesh: Group1D) -> torch.Tensor:
    """Dispatch/combine round trip through expert-sharded FFNs.

    ``x``: this rank's (n * C, D) tokens; ``w``: this rank's (D, D) expert
    weight.  Token group ``k`` of every rank routes to expert ``k``
    (deterministic balanced routing, fixed capacity): two
    ``all_to_all_single`` and one matmul a pass."""

    recv = torch.empty_like(x)
    with mesh.scope():
        dist.all_to_all_single(recv, x.contiguous(), group=mesh.group)
    y = (recv @ w).to(x.dtype)   # this rank's expert
    back = torch.empty_like(y)
    with mesh.scope():
        dist.all_to_all_single(back, y, group=mesh.group)
    return back


def moe_reference(x_global: torch.Tensor, w: torch.Tensor,
                  n_dev: int) -> torch.Tensor:
    """Dense oracle: token group k of each rank through expert k."""

    n = w.shape[0]
    if n != n_dev:
        raise ValueError(f"{n} experts for {n_dev} ranks")
    c = x_global.shape[0] // n_dev // n
    xg = x_global.reshape(n_dev, n, c, -1).float()
    out = torch.einsum("dkce,kef->dkcf", xg, w.float())
    return out.reshape(x_global.shape).to(x_global.dtype)


def moe_alltoall_load(mesh: Optional[Group1D] = None, axis: str = "expert",
                      d: int = 512, tokens_per_device: int = 256,
                      device="cuda"):
    """(step_fn, state): sustained MoE dispatch/combine traffic, the output
    renormalised by its RMS over every rank (one scalar all-reduce, as the
    reference's global mean compiles to one)."""

    if mesh is None:
        mesh = make_seq_mesh(axis=axis)
    n = mesh.size
    c = max(1, tokens_per_device // n)
    w = _stage_weights(13, n, d)[mesh.rank].to(device)
    x = seeded_shard((n * n * c, d), 14, mesh, 0, device)

    def step(state: torch.Tensor) -> torch.Tensor:
        out = moe_forward(state, w, mesh)
        sq = out.float().square().sum().reshape(1)
        with mesh.scope():
            dist.all_reduce(sq, group=mesh.group)
        scale = torch.sqrt(sq / (out.numel() * n) + 1e-6)
        return (out / scale).to(state.dtype)

    return step, x
