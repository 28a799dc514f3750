"""Transformer load generator in PyTorch.

Counterpart of ``tpumon/loadgen/model.py`` (configs, parameters, forward,
loss, one SGD step and the analytic dot-FLOP count), with the same
numerics:

* f32 master weights, every float parameter cast to bf16 inside
  :func:`forward` (a bf16 master stalls SGD: lr*g below the bf16 ulp of
  the weights rounds away);
* RMSNorm variance in f32, its ``rsqrt`` cast to bf16 before the
  multiplies;
* dense attention masks with ``finfo(bf16).min`` and takes its softmax in
  f32; ``flash=True`` runs :func:`..kernels.flash_attention`, the CUDA
  kernels on the card;
* GELU in its tanh form (``jax.nn.gelu``'s default);
* the stacked per-layer tensors (leading axis = layer) are walked by a
  Python loop where JAX used ``lax.scan``;
* the SGD update in f32.

Parameters are a plain dict of tensors with the JAX pytree's structure,
so :func:`params_from_jax` loads a JAX init exactly.

Sharding (the reference's dp x tp layout, bottom of the file): the
reference binds ``NamedSharding``s to a jitted step and XLA inserts the
collectives; here every rank of a ``torch.distributed`` group (NCCL on
the card, gloo on the CPU) holds its own shards (:func:`shard_params`, by
the reference's :func:`param_specs`) and calls the collectives itself,
through Megatron-LM's four tensor-parallel conjugates over its row of the
mesh (:func:`copy_to`, :func:`reduce_from`, :func:`gather_from`,
:func:`scatter_to`), and all-reduces its gradients over its column
(:func:`sharded_train_step`).  The unsharded functions are the same code
with no model group.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from .ring import Group1D, _all_gather, _group1d


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    vocab: int = 512
    d_model: int = 256
    n_heads: int = 4
    n_layers: int = 2
    d_ff: int = 512
    seq_len: int = 128
    #: run attention through the flash kernels (forward + dQ + dK/dV)
    #: instead of materialized-score softmax
    flash: bool = False

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @classmethod
    def tiny(cls) -> "ModelConfig":
        """Shapes for CPU dry runs."""

        return cls(vocab=128, d_model=128, n_heads=2, n_layers=2,
                   d_ff=256, seq_len=32)

    @classmethod
    def bench(cls) -> "ModelConfig":
        """The monitored bench workload's shapes."""

        return cls(vocab=2048, d_model=1024, n_heads=8, n_layers=2,
                   d_ff=2048, seq_len=256, flash=True)


Params = Dict[str, Any]


def tree_map(fn: Callable[[torch.Tensor], Any], tree: Any) -> Any:
    """Apply ``fn`` to every leaf of a nested dict."""

    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def tree_leaves(tree: Any) -> List[torch.Tensor]:
    """Leaves of a nested dict, in key-insertion order."""

    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    return [tree]


def init_params(gen: torch.Generator, cfg: ModelConfig,
                dtype=torch.float32) -> Params:
    """Stacked-layer parameters (leading axis = layer) on ``gen``'s
    device, drawn from ``gen``.  The numbers differ from JAX's for the
    same seed; :func:`params_from_jax` loads a JAX init instead."""

    device = gen.device
    L, D, Fd = cfg.n_layers, cfg.d_model, cfg.d_ff

    def norm(shape, fan_in):
        return (torch.randn(shape, generator=gen, device=device,
                            dtype=torch.float32) * (fan_in ** -0.5)).to(dtype)

    def ones(shape):
        return torch.ones(shape, dtype=dtype, device=device)

    return {
        "embed": norm((cfg.vocab, D), D),
        "layers": {
            "wqkv": norm((L, D, 3 * D), D),
            "wo": norm((L, D, D), D),
            "w1": norm((L, D, Fd), D),
            "w2": norm((L, Fd, D), Fd),
            "ln1": ones((L, D)),
            "ln2": ones((L, D)),
        },
        "ln_f": ones((D,)),
        "unembed": norm((D, cfg.vocab), D),
    }


def params_from_jax(np_params: Any, device="cuda",
                    mesh: Optional["Mesh2D"] = None) -> Params:
    """Load a JAX parameter pytree given as numpy arrays (for example
    ``jax.tree_util.tree_map(np.asarray, params)``) onto ``device``; with
    ``mesh``, this rank's shards of it (:func:`shard_params`)."""

    params = tree_map(lambda a: torch.tensor(a, device=device), np_params)
    return params if mesh is None else shard_params(params, mesh)


def _rmsnorm(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    var = x.float().square().mean(dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + 1e-6).to(x.dtype)) * scale


def _col(h: torch.Tensor, w: torch.Tensor, tp: Optional[Group1D],
         gather: bool) -> torch.Tensor:
    """``h @ w``; over a model group ``w`` is this rank's block of columns
    and ``h`` is the same on every rank of the group: the product's
    columns gathered (``gather``) or kept as this rank's block."""

    if tp is None:
        return h @ w
    y = copy_to(h, tp) @ w
    return gather_from(y, tp) if gather else y


def _row(a: torch.Tensor, w: torch.Tensor, tp: Optional[Group1D],
         scatter: bool) -> torch.Tensor:
    """``a @ w``; over a model group ``w`` is this rank's block of rows,
    ``a`` the whole input (``scatter``: this rank's block taken here) or
    this rank's block of it, and the partial products are summed."""

    if tp is None:
        return a @ w
    if scatter:
        a = scatter_to(a, tp)
    return reduce_from(a @ w, tp)


def _layer(cfg: ModelConfig, x: torch.Tensor, layer: Params,
           tp: Optional[Group1D] = None) -> torch.Tensor:
    """One block; ``tp``: the model group ``layer``'s shards are split
    over (None: whole weights)."""

    B, S, D = x.shape
    H, Hd = cfg.n_heads, cfg.head_dim

    h = _rmsnorm(x, layer["ln1"])
    # wqkv's column blocks cross the q/k/v boundaries (the reference's
    # layout): attention sees the gathered product, every head
    q, k, v = _col(h, layer["wqkv"], tp, gather=True).split(D, dim=-1)
    if cfg.flash:
        from .kernels import flash_attention

        ctx = flash_attention(q.reshape(B, S, H, Hd), k.reshape(B, S, H, Hd),
                              v.reshape(B, S, H, Hd), causal=True)
        ctx = ctx.reshape(B, S, D)
    else:
        q = q.reshape(B, S, H, Hd).transpose(1, 2)
        k = k.reshape(B, S, H, Hd).transpose(1, 2)
        v = v.reshape(B, S, H, Hd).transpose(1, 2)
        scores = (q @ k.transpose(-1, -2)) / (Hd ** 0.5)
        mask = torch.ones((S, S), dtype=torch.bool, device=x.device).tril()
        scores = scores.masked_fill(~mask, torch.finfo(scores.dtype).min)
        attn = torch.softmax(scores.float(), dim=-1).to(x.dtype)
        ctx = (attn @ v).transpose(1, 2).reshape(B, S, D)
    x = x + _row(ctx, layer["wo"], tp, scatter=True)

    h = _rmsnorm(x, layer["ln2"])
    ff = F.gelu(_col(h, layer["w1"], tp, gather=False), approximate="tanh")
    return x + _row(ff, layer["w2"], tp, scatter=False)


def forward(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
            tp: Optional[Group1D] = None) -> torch.Tensor:
    """tokens (B, S) int -> logits (B, S, vocab) bf16.  ``tp``: the model
    group ``params``' shards are split over (None: whole weights)."""

    p = tree_map(lambda t: t.to(torch.bfloat16)
                 if t.is_floating_point() else t, params)
    x = p["embed"][tokens]
    if tp is not None:
        x = gather_from(x, tp)
    layers = p["layers"]
    for i in range(cfg.n_layers):
        x = _layer(cfg, x, {name: t[i] for name, t in layers.items()}, tp)
    x = _rmsnorm(x, p["ln_f"])
    return _row(x, p["unembed"], tp, scatter=True)


def loss_fn(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
            tp: Optional[Group1D] = None) -> torch.Tensor:
    """Next-token cross entropy (mean over batch x positions)."""

    logits = forward(cfg, params, tokens[:, :-1], tp).float()
    targets = tokens[:, 1:]
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, targets[..., None].long())
    return nll.mean()


def train_step(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
               lr: float = 1e-3) -> Tuple[Params, torch.Tensor]:
    """One SGD step.  Updates ``params`` in place (no second copy of the
    weights) and returns them with the step's loss."""

    leaves = _float_leaves(params)
    loss = loss_fn(cfg, params, tokens)
    _sgd(leaves, torch.autograd.grad(loss, leaves), lr)
    return params, loss.detach()


def _float_leaves(params: Params) -> List[torch.Tensor]:
    leaves = [t for t in tree_leaves(params) if t.is_floating_point()]
    for t in leaves:
        t.requires_grad_(True)
    return leaves


def _sgd(leaves, grads, lr: float) -> None:
    """The f32 SGD update, in place."""

    with torch.no_grad():
        for t, g in zip(leaves, grads):
            t.copy_(t.float() - lr * g.float())


def train_step_dot_flops(cfg: ModelConfig, batch: int) -> int:
    """Analytic matmul FLOPs for ONE ``train_step`` execution.

    Counts every matmul at 2*m*n*k with the standard backward factor
    (each forward matmul induces two in the gradient pass, so total = 3x
    forward); elementwise, softmax and norm work are excluded.  Note
    ``loss_fn`` trims the sequence to S-1 positions.
    """

    B, D, Fd, V = batch, cfg.d_model, cfg.d_ff, cfg.vocab
    S = cfg.seq_len - 1
    per_layer = 2 * B * S * (
        3 * D * D        # qkv projection
        + 2 * S * D      # scores (q@k) + context (attn@v)
        + D * D          # output projection
        + 2 * D * Fd)    # ff up + down
    fwd = cfg.n_layers * per_layer + 2 * B * S * D * V  # + unembed
    return 3 * fwd


# ---- sharding layout (dp x tp groups) ----------------------------------------

#: a leaf's layout: per dimension, the mesh axis it is split over (None:
#: whole), as the reference's ``PartitionSpec``
Spec = Tuple[Optional[str], ...]

#: the span around the step's gradient sync over the data group
GRAD_SYNC_SPAN = "tpumon.grad_sync"


def param_specs(cfg: Optional[ModelConfig] = None) -> Params:
    """Tensor-parallel layout: column-parallel in-projections, row-parallel
    out-projections (Megatron-style), replicated norms; the reference's
    specs leaf for leaf."""

    return {
        "embed": (None, "model"),
        "layers": {
            "wqkv": (None, None, "model"),
            "wo": (None, "model", None),
            "w1": (None, None, "model"),
            "w2": (None, "model", None),
            "ln1": (None, None),
            "ln2": (None, None),
        },
        "ln_f": (None,),
        "unembed": ("model", None),
    }


def batch_spec() -> Spec:
    return ("data", None)


def mesh_shape(n_devices: int) -> Tuple[int, int]:
    """(dp, tp): the reference's factorization, which prefers both axes
    at 2 or more (dp >= 2 and tp >= 2), so the dry run runs data-parallel
    all-reduces and tensor-parallel collectives."""

    tp = 1
    for cand in (4, 2):
        if n_devices % cand == 0 and n_devices // cand >= 2:
            tp = cand
            break
    if tp == 1 and n_devices % 2 == 0:
        tp = 2  # 2 devices: pure TP
    return n_devices // tp, tp


@dataclasses.dataclass(frozen=True)
class Mesh2D:
    """This rank's place in a (data, model) mesh: the port's counterpart
    of the reference's 2D ``Mesh``.  Rank r sits at (r // tp, r % tp),
    row-major as ``np.array(devices).reshape(dp, tp)`` lays devices out."""

    #: this rank's column: the ranks at its model position, one a row
    data: Group1D
    #: this rank's row: the ranks its weights are split over
    model: Group1D

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.data.size, self.model.size)

    def axis(self, name: str) -> Group1D:
        return {"data": self.data, "model": self.model}[name]


def make_mesh(n_devices: Optional[int] = None) -> Mesh2D:
    """(data, model) groups over the first ``n_devices`` ranks (default:
    all), :func:`mesh_shape`'s factorization.  Every rank of the world
    must call it; a rank beyond ``n_devices`` gets groups it is no member
    of (rank -1)."""

    world = dist.get_world_size()
    n = world if n_devices is None else n_devices
    if not 1 <= n <= world:
        raise ValueError(f"need {n} ranks, have {world}")
    dp, tp = mesh_shape(n)
    idle = Group1D(None, (), -1)
    data = model = idle
    for d in range(dp):
        g = _group1d(range(d * tp, (d + 1) * tp), "model")
        model = g if g.rank >= 0 else model
    for m in range(tp):
        g = _group1d(range(m, n, tp), "data")
        data = g if g.rank >= 0 else data
    return Mesh2D(data, model)


def _zip_map(fn, tree: Any, specs: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _zip_map(fn, v, specs[k]) for k, v in tree.items()}
    return fn(tree, specs)


def shard(t: torch.Tensor, spec: Spec, mesh: Mesh2D) -> torch.Tensor:
    """This rank's block of ``t`` under ``spec`` (a copy: the step
    updates it in place)."""

    for dim, ax in enumerate(spec):
        if ax is None:
            continue
        g = mesh.axis(ax)
        if t.shape[dim] % g.size:
            raise ValueError(f"dim {dim} of {tuple(t.shape)} does not split "
                             f"{g.size} ways over {ax!r}")
        size = t.shape[dim] // g.size
        t = t.narrow(dim, g.rank * size, size)
    return t.clone(memory_format=torch.contiguous_format)


def shard_params(params: Params, mesh: Mesh2D,
                 cfg: Optional[ModelConfig] = None) -> Params:
    """This rank's shards of whole parameters (:func:`param_specs`)."""

    return _zip_map(lambda t, s: shard(t, s, mesh), params, param_specs(cfg))


def gather_params(params: Params, mesh: Mesh2D) -> Params:
    """Whole parameters from every rank's shards (the inverse of
    :func:`shard_params`), on every rank of the model group."""

    def whole(t, spec):
        for dim, ax in enumerate(spec):
            if ax is not None:
                t = _gather(t.detach(), dim, mesh.axis(ax))
        return t

    return _zip_map(whole, params, param_specs())


# ---- the tensor-parallel conjugates (Megatron-LM's names) --------------------

def _all_reduce(x: torch.Tensor, g: Group1D) -> torch.Tensor:
    y = x.clone(memory_format=torch.contiguous_format)
    with g.scope():
        dist.all_reduce(y, group=g.group)
    return y


def _gather(x: torch.Tensor, dim: int, g: Group1D) -> torch.Tensor:
    """Every member's ``x`` concatenated along ``dim``, in group order,
    laid out as the unsharded model's tensor would be (contiguous: the
    products after it see the strides they see unsharded)."""

    y = x.movedim(dim, 0).contiguous()
    out = torch.empty((g.size * y.shape[0],) + tuple(y.shape[1:]),
                      dtype=y.dtype, device=y.device)
    with g.scope():
        _all_gather(out, y, g.group)
    return out.movedim(0, dim).contiguous()


def _own_block(x: torch.Tensor, g: Group1D) -> torch.Tensor:
    """This member's block of ``x``'s last dimension."""

    c = x.shape[-1] // g.size
    return x[..., g.rank * c:(g.rank + 1) * c].contiguous()


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g):
        ctx.g = g
        return x.view_as(x)

    @staticmethod
    def backward(ctx, dy):
        return _all_reduce(dy, ctx.g), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g):
        return _all_reduce(x, g)

    @staticmethod
    def backward(ctx, dy):
        return dy, None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g):
        ctx.g = g
        return _gather(x, -1, g)

    @staticmethod
    def backward(ctx, dy):
        return _own_block(dy, ctx.g), None


class _ScatterTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g):
        ctx.g = g
        return _own_block(x, g)

    @staticmethod
    def backward(ctx, dy):
        return _gather(dy, -1, ctx.g), None


def copy_to(x: torch.Tensor, g: Group1D) -> torch.Tensor:
    """Identity forward, all-reduce of the gradient over ``g`` backward:
    the input of a column-parallel product."""

    return _CopyTo.apply(x, g)


def reduce_from(x: torch.Tensor, g: Group1D) -> torch.Tensor:
    """All-reduce over ``g`` forward, identity backward: the output of a
    row-parallel product."""

    return _ReduceFrom.apply(x, g)


def gather_from(x: torch.Tensor, g: Group1D) -> torch.Tensor:
    """All-gather along the last dim forward, this rank's block of the
    gradient backward."""

    return _GatherFrom.apply(x, g)


def scatter_to(x: torch.Tensor, g: Group1D) -> torch.Tensor:
    """This rank's block of the last dim forward, all-gather of the
    gradient backward."""

    return _ScatterTo.apply(x, g)


def sharded_loss_fn(cfg: ModelConfig, mesh: Mesh2D, params: Params,
                    tokens: torch.Tensor) -> torch.Tensor:
    """:func:`loss_fn` on this rank's shards and rows: the mean over its
    rows."""

    return loss_fn(cfg, params, tokens, mesh.model)


def sharded_train_step(cfg: ModelConfig, mesh: Mesh2D):
    """The step over ``mesh``: ``step(params, tokens, lr=1e-3) ->
    (params, loss)`` on this rank's shards and rows (``tokens``: its
    ``batch_spec`` rows), the counterpart of the reference's jitted step
    with its shardings bound in.  Each gradient is all-reduced over the
    data group and divided by dp (one all-reduce of every gradient
    flattened into one buffer, as DDP buckets them), then the f32 SGD
    update runs in place; the loss returned is the mean over every row,
    as the reference's.  At dp = tp = 1 it computes what
    :func:`train_step` computes."""

    dp = mesh.data.size

    def step(params: Params, tokens: torch.Tensor, lr: float = 1e-3):
        from torch.profiler import record_function

        leaves = _float_leaves(params)
        loss = sharded_loss_fn(cfg, mesh, params, tokens)
        grads = torch.autograd.grad(loss, leaves)
        with torch.no_grad(), record_function(GRAD_SYNC_SPAN):
            flat = torch.cat([gr.reshape(-1) for gr in grads])
            with mesh.data.scope():
                dist.all_reduce(flat, group=mesh.data.group)
            flat.div_(dp)
            grads = [f.view_as(gr) for f, gr in zip(
                flat.split([gr.numel() for gr in grads]), grads)]
        _sgd(leaves, grads, lr)
        with torch.no_grad():
            loss = _all_reduce(loss.detach().reshape(1), mesh.data) / dp
        return params, loss[0]

    return step
