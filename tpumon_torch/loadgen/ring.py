"""Ring collectives: sequence-parallel attention and NVLink load shaping.

Counterpart of ``tpumon/loadgen/ring.py`` over ``torch.distributed``.  The
process model differs: JAX runs one controller over a ``Mesh`` and
``shard_map``; torch runs one process per rank, each holding its own
shard.  So every function here runs on every rank of a process group
(NCCL on the card, one card per rank; gloo on the CPU), takes and returns
the calling rank's shard, and the mesh constructors return process groups:

* :func:`make_seq_mesh` — the 1D group (:class:`Group1D`);
* :func:`make_multislice_mesh` — the (slice, chip) groups
  (:class:`MultiSlice`), built with ``dist.new_group``.

Two roles, as in the reference:

* :func:`ring_attention` — blockwise-causal attention with the sequence
  sharded across ranks and K/V blocks rotating around the ring by
  ``batch_isend_irecv`` (to ``(r + 1) % n``, from ``(r - 1) % n``); the
  block attend is :func:`.kernels.attention_combine`.
* :func:`ring_allreduce_load` / :func:`dcn_allreduce_load` — sustained
  all-reduce traffic, flat and hierarchical.

A 1-rank group degenerates as the reference's 1-device mesh does: every
rotation is the identity (no P2P is issued: torch refuses a send to
one's own rank), so the same code runs on one card.  Every collective is
called inside its group's :func:`tpumon_torch.collectives.group_scope`,
which tells the trace engine's attribution the group it ran over.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from .. import collectives as C
from .kernels import attention_combine as _block_attend


@dataclass(frozen=True)
class Group1D:
    """A 1D process group: the port's counterpart of a 1-axis ``Mesh``."""

    #: the ``torch.distributed`` group (``dist.group.WORLD`` for all ranks)
    group: object
    #: global ranks of the members, in group order
    ranks: Tuple[int, ...]
    #: this process's position in the group (-1: not a member)
    rank: int
    axis: str = "seq"
    #: the members sit in different slices (their bytes are DCN)
    crosses_slices: bool = False

    @property
    def size(self) -> int:
        return len(self.ranks)

    def scope(self):
        """The attribution scope of a collective over this group."""

        return C.group_scope(self.size, self.crosses_slices)

    def shift(self, *tensors: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """Each tensor sent to the next member and replaced by the
        previous member's (the reference's cyclic ``ppermute``); the
        identity on a 1-member group."""

        n = self.size
        if n == 1:
            return tensors
        nxt = self.ranks[(self.rank + 1) % n]
        prv = self.ranks[(self.rank - 1) % n]
        out = tuple(torch.empty_like(t) for t in tensors)
        ops = []
        for t, o in zip(tensors, out):
            ops.append(dist.P2POp(dist.isend, t.contiguous(), nxt,
                                  self.group))
            ops.append(dist.P2POp(dist.irecv, o, prv, self.group))
        with self.scope():
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        return out


@dataclass(frozen=True)
class MultiSlice:
    """(slice, chip) groups: the port's counterpart of the reference's 2D
    multi-slice ``Mesh``.  Ranks are laid out slice-major (rank =
    slice * chips + chip)."""

    #: this rank's group within its slice (ICI)
    chip: Group1D
    #: this rank's group across slices, same chip position (DCN)
    slice: Group1D
    n_slices: int
    chips: int
    #: False on a rank beyond ``n_slices * chips`` (it idles)
    member: bool


def _new_group(ranks) -> object:
    """``dist.new_group`` (every rank calls it for every group, in the
    same order); the world group when it spans every rank."""

    ranks = list(ranks)
    if ranks == list(range(dist.get_world_size())):
        return dist.group.WORLD
    return dist.new_group(ranks)


def _group1d(ranks, axis: str, crosses_slices: bool = False) -> Group1D:
    ranks = tuple(ranks)
    me = dist.get_rank()
    return Group1D(_new_group(ranks), ranks,
                   ranks.index(me) if me in ranks else -1, axis,
                   crosses_slices)


def make_seq_mesh(n_devices: Optional[int] = None,
                  axis: str = "seq") -> Group1D:
    """1D group over the first ``n_devices`` ranks (default: all): the
    reference's 1D ``Mesh``.  Every rank of the world must call it."""

    world = dist.get_world_size()
    n = world if n_devices is None else n_devices
    if not 1 <= n <= world:
        raise ValueError(f"need {n} ranks, have {world}")
    return _group1d(range(n), axis)


def make_multislice_mesh(n_slices: int,
                         chips_per_slice: Optional[int] = None,
                         slice_axis: str = "slice",
                         chip_axis: str = "chip") -> MultiSlice:
    """(slice, chip) groups: the multi-slice topology.  Collectives over
    the slice groups cross slice boundaries (DCN); the chip groups stay
    within a slice.  Every rank of the world must call it."""

    world = dist.get_world_size()
    if n_slices < 1:
        raise ValueError(f"n_slices must be >= 1, got {n_slices}")
    if chips_per_slice is None:
        chips_per_slice = world // n_slices
    n = n_slices * chips_per_slice
    if chips_per_slice < 1 or world < n:
        raise ValueError(f"need {n_slices}x{max(chips_per_slice, 1)} "
                         f"ranks, have {world}")
    me = dist.get_rank()
    chip = slc = None
    for s in range(n_slices):
        g = _group1d(range(s * chips_per_slice, (s + 1) * chips_per_slice),
                     chip_axis)
        if g.rank >= 0:
            chip = g
    for c in range(chips_per_slice):
        g = _group1d(range(c, n, chips_per_slice), slice_axis,
                     crosses_slices=n_slices > 1)
        if g.rank >= 0:
            slc = g
    idle = Group1D(None, (), -1)
    return MultiSlice(chip or idle, slc or idle, n_slices, chips_per_slice,
                      me < n)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   mesh: Group1D, causal: bool = True) -> torch.Tensor:
    """Sequence-parallel causal attention over a ring.

    ``q``/``k``/``v``: this rank's (B, S/n, H, D) shard of the sequence;
    returns its shard of the output.  Q stays resident and every K/V shard
    arrives once, by n neighbour rotations a pass (the last one returns
    the rank's own block, as the reference's scan does).  Causality across
    blocks uses the ring position: after hop r the rank holding block i
    attends block (i - r) mod n, strictly earlier blocks in full, the
    diagonal with the in-block mask, later ones not at all (an all-False
    mask, a no-op in the block attend)."""

    n, my = mesh.size, mesh.rank
    scale = q.shape[-1] ** -0.5
    q_l = q.transpose(1, 2)
    k_cur = k.transpose(1, 2).contiguous()
    v_cur = v.transpose(1, 2).contiguous()
    B, H, sq, D = q_l.shape
    dev = q.device
    diag = None
    if causal:
        pos = torch.arange(sq, device=dev)
        diag = pos[:, None] >= pos[None, :]
    m = torch.full((B, H, sq, 1), float("-inf"), device=dev)
    l = torch.zeros((B, H, sq, 1), device=dev)
    acc = torch.zeros((B, H, sq, D), device=dev)
    for r in range(n):
        src = (my - r) % n
        mask = None
        if causal:
            mask = (torch.ones_like(diag) if src < my else diag
                    if src == my else torch.zeros_like(diag))
        m, l, acc = _block_attend(q_l, k_cur, v_cur, m, l, acc, scale=scale,
                                  mask=mask)
        k_cur, v_cur = mesh.shift(k_cur, v_cur)
    out = acc / torch.clamp_min(l, 1e-20)
    return out.transpose(1, 2).to(q.dtype)


def ring_attention_reference(q, k, v, causal: bool = True) -> torch.Tensor:
    """Dense single-device attention — the test oracle for the ring path."""

    qf, kf, vf = (x.transpose(1, 2).float() for x in (q, k, v))
    s = torch.einsum("bhqd,bhkd->bhqk", qf, kf) * (q.shape[-1] ** -0.5)
    if causal:
        S = q.shape[1]
        mask = torch.tril(torch.ones((S, S), dtype=torch.bool,
                                     device=q.device))
        s = s.masked_fill(~mask, float("-inf"))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", p, vf)
    return out.transpose(1, 2).to(q.dtype)


def ring_allreduce_load(mesh: Group1D, mb_per_device: int = 8,
                        device="cuda"):
    """Return (step_fn, state): sustained all-reduce traffic over ``mesh``.

    Each step all-reduces this rank's ``mb_per_device`` MiB f32 buffer in
    place and divides by the group size, so the ones state stays ones and
    the loop can run forever."""

    n_elem = mb_per_device * 1024 * 1024 // 4
    n = mesh.size

    def step(x: torch.Tensor) -> torch.Tensor:
        with mesh.scope():
            dist.all_reduce(x, group=mesh.group)
        return x.div_(n)

    # materialised on each rank: its own shard only
    return step, torch.ones((n_elem,), dtype=torch.float32, device=device)


def _reduce_scatter(out, x, group) -> None:
    fn = getattr(dist, "reduce_scatter_single", None) or \
        dist.reduce_scatter_tensor
    fn(out, x, group=group)


def _all_gather(out, x, group) -> None:
    fn = getattr(dist, "all_gather_single", None) or \
        dist.all_gather_into_tensor
    fn(out, x, group=group)


def dcn_allreduce_load(ms: MultiSlice, mb_per_device: int = 4,
                       device="cuda"):
    """Return (step_fn, state): hierarchical multi-slice gradient sync.

    Reduce-scatter within the slice, all-reduce the 1/chips-sized shard
    across slices, all-gather back within the slice, then divide by the
    rank count: equal to a flat all-reduce mean, so the ones state stays
    ones.  A rank outside the ``n_slices * chips`` grid steps the
    identity (the reference leaves such chips idle)."""

    n_elem = mb_per_device * 1024 * 1024 // 4
    chips = ms.chips
    total = chips * ms.n_slices
    # this rank's buffer must split evenly across the reduce-scatter
    n_elem -= n_elem % chips
    state = torch.ones((n_elem,), dtype=torch.float32, device=device)
    if not ms.member:
        return (lambda x: x), state

    def step(x: torch.Tensor) -> torch.Tensor:
        shard = torch.empty((n_elem // chips,), dtype=x.dtype,
                            device=x.device)
        with ms.chip.scope():
            _reduce_scatter(shard, x, ms.chip.group)
        with ms.slice.scope():
            dist.all_reduce(shard, group=ms.slice.group)
        out = torch.empty_like(x)
        with ms.chip.scope():
            _all_gather(out, shard, ms.chip.group)
        return out.div_(total)

    return step, state


def seeded_shard(shape, seed: int, mesh: Group1D, dim: int, device,
                 dtype=torch.bfloat16) -> torch.Tensor:
    """This rank's block along ``dim`` of a global normal tensor drawn
    from ``seed`` (the same global tensor on every rank)."""

    g = torch.Generator("cpu").manual_seed(seed)
    full = torch.randn(shape, generator=g).to(dtype)
    n = max(mesh.size, 1)
    return full.chunk(n, dim=dim)[max(mesh.rank, 0)].contiguous().to(device)


def make_ring_attention_pattern(mesh: Optional[Group1D] = None,
                                axis: str = "seq",
                                seq_per_device: int = 512,
                                batch: int = 1, heads: int = 4,
                                head_dim: int = 128, device="cuda"):
    """(step_fn, state) for the loadgen: repeated ring-attention passes,
    the output fed back as Q so successive steps stay data-dependent."""

    if mesh is None:
        mesh = make_seq_mesh(axis=axis)
    shape = (batch, seq_per_device * mesh.size, heads, head_dim)
    q, k, v = (seeded_shard(shape, seed, mesh, 1, device)
               for seed in (7, 8, 9))

    def step(state):
        q_cur, k_cur, v_cur = state
        return (ring_attention(q_cur, k_cur, v_cur, mesh, causal=True),
                k_cur, v_cur)

    return step, (q, k, v)


def refuse_beyond_cards(world: int) -> None:
    """Raise unless every one of ``world`` NCCL ranks has a card of its
    own: NCCL refuses two ranks on one card, and nothing quietly becomes
    gloo."""

    cards = torch.cuda.device_count()
    if world > cards:
        raise RuntimeError(
            f"{world} ranks on {cards} CUDA device(s): NCCL runs one "
            f"rank a card (pass --device cpu for gloo ranks)")


def init_process_group(device: torch.device,
                       coordinator: Optional[str] = None,
                       num_processes: Optional[int] = None,
                       process_id: Optional[int] = None) -> torch.device:
    """Join the run's process group and return this rank's device.

    NCCL on ``cuda`` (one card per rank: rank r takes ``cuda:r``), gloo on
    the CPU.  With ``coordinator`` (``HOST:PORT``) the group spans
    ``num_processes`` processes; without it, a 1-rank group in this
    process.  More ranks than cards is refused: NCCL refuses two ranks on
    one card, and nothing quietly becomes gloo."""

    world = 1 if coordinator is None else int(num_processes)
    rank = 0 if coordinator is None else int(process_id)
    if device.type == "cuda":
        refuse_beyond_cards(world)
        device = torch.device("cuda", rank)
        torch.cuda.set_device(device)
        backend = "nccl"
    else:
        backend = "gloo"
    if coordinator is None:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
    else:
        dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                                rank=rank, world_size=world)
    # one all-reduce now: a group that cannot communicate fails here,
    # before the run, never mid-window
    probe = torch.ones((1,), device=device)
    dist.all_reduce(probe)
    if probe.item() != world:
        raise RuntimeError(f"process group check: all_reduce gave "
                           f"{probe.item()}, want {world}")
    return device
