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
so :func:`params_from_jax` loads a JAX init exactly.  Sharding is not
ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Tuple

import torch
import torch.nn.functional as F


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


def params_from_jax(np_params: Any, device="cuda") -> Params:
    """Load a JAX parameter pytree given as numpy arrays (for example
    ``jax.tree_util.tree_map(np.asarray, params)``) onto ``device``."""

    return tree_map(lambda a: torch.tensor(a, device=device), np_params)


def _rmsnorm(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    var = x.float().square().mean(dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + 1e-6).to(x.dtype)) * scale


def _layer(cfg: ModelConfig, x: torch.Tensor, layer: Params) -> torch.Tensor:
    B, S, D = x.shape
    H, Hd = cfg.n_heads, cfg.head_dim

    h = _rmsnorm(x, layer["ln1"])
    qkv = h @ layer["wqkv"]
    q, k, v = qkv.split(D, dim=-1)
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
    x = x + ctx @ layer["wo"]

    h = _rmsnorm(x, layer["ln2"])
    ff = F.gelu(h @ layer["w1"], approximate="tanh")
    return x + ff @ layer["w2"]


def forward(cfg: ModelConfig, params: Params,
            tokens: torch.Tensor) -> torch.Tensor:
    """tokens (B, S) int -> logits (B, S, vocab) bf16."""

    p = tree_map(lambda t: t.to(torch.bfloat16)
                 if t.is_floating_point() else t, params)
    x = p["embed"][tokens]
    layers = p["layers"]
    for i in range(cfg.n_layers):
        x = _layer(cfg, x, {name: t[i] for name, t in layers.items()})
    x = _rmsnorm(x, p["ln_f"])
    return x @ p["unembed"]


def loss_fn(cfg: ModelConfig, params: Params,
            tokens: torch.Tensor) -> torch.Tensor:
    """Next-token cross entropy (mean over batch x positions)."""

    logits = forward(cfg, params, tokens[:, :-1]).float()
    targets = tokens[:, 1:]
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, targets[..., None].long())
    return nll.mean()


def train_step(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
               lr: float = 1e-3) -> Tuple[Params, torch.Tensor]:
    """One SGD step.  Updates ``params`` in place (no second copy of the
    weights) and returns them with the step's loss."""

    leaves = [t for t in tree_leaves(params) if t.is_floating_point()]
    for t in leaves:
        t.requires_grad_(True)
    loss = loss_fn(cfg, params, tokens)
    grads = torch.autograd.grad(loss, leaves)
    with torch.no_grad():
        for t, g in zip(leaves, grads):
            t.copy_(t.float() - lr * g.float())
    return params, loss.detach()


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
