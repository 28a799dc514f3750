"""The bench transformer's SGD step in plain PyTorch, written from its
description: token embedding; per layer RMSNorm (eps 1e-6), a fused QKV
projection, causal softmax attention over ``n_heads`` heads, the output
projection and a residual, RMSNorm, a tanh-GELU MLP and a residual; a
final RMSNorm and the unembedding; next-token cross entropy averaged over
batch and positions; plain SGD on every floating parameter.

It computes in float32 with TF32 off (the caller's job: ``fp32()``).
With ``fp8=True`` it is the control: every matrix product takes its
operands rounded to float8 e4m3 (each tensor scaled by its largest
magnitude first), forward and backward, the precision below the bf16
the configuration states.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, Iterator, List, Tuple

import torch
import torch.nn.functional as F

E4M3_MAX = 448.0
#: the layout of the parameters: (name, shape from the model sizes)
LEAVES = ("embed", "wqkv", "wo", "w1", "w2", "ln1", "ln2", "ln_f", "unembed")


@contextlib.contextmanager
def fp32() -> Iterator[None]:
    """float32 products with TF32 off, restored after."""

    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def to_e4m3(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under a per-tensor scale, back in
    float32."""

    amax = x.detach().abs().max().clamp(min=1e-30)
    scale = E4M3_MAX / amax
    return (x * scale).to(torch.float8_e4m3fn).to(torch.float32) / scale


class _Fp8Matmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return to_e4m3(a) @ to_e4m3(b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g8 = to_e4m3(g)
        return g8 @ to_e4m3(b).transpose(-1, -2), \
            to_e4m3(a).transpose(-1, -2) @ g8


def _mm(fp8: bool):
    return _Fp8Matmul.apply if fp8 else torch.matmul


def _rmsnorm(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + 1e-6) \
        * scale


def loss(model: Dict[str, int], p: Dict[str, torch.Tensor],
         tokens: torch.Tensor, fp8: bool = False) -> torch.Tensor:
    """Mean next-token cross entropy of ``tokens`` (B, S) under ``p``."""

    mm = _mm(fp8)
    inp, tgt = tokens[:, :-1], tokens[:, 1:]
    B, S = inp.shape
    D, H = model["d_model"], model["n_heads"]
    Hd = D // H
    mask = torch.ones((S, S), dtype=torch.bool, device=tokens.device).tril()
    x = p["embed"][inp]
    for i in range(model["n_layers"]):
        h = _rmsnorm(x, p["ln1"][i])
        q, k, v = mm(h, p["wqkv"][i]).split(D, dim=-1)
        q, k, v = (t.reshape(B, S, H, Hd).transpose(1, 2) for t in (q, k, v))
        scores = mm(q, k.transpose(-1, -2)) / math.sqrt(Hd)
        scores = scores.masked_fill(~mask, float("-inf"))
        ctx = mm(torch.softmax(scores, dim=-1), v)
        x = x + mm(ctx.transpose(1, 2).reshape(B, S, D), p["wo"][i])
        h = _rmsnorm(x, p["ln2"][i])
        x = x + mm(F.gelu(mm(h, p["w1"][i]), approximate="tanh"),
                   p["w2"][i])
    logits = mm(_rmsnorm(x, p["ln_f"]), p["unembed"])
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           tgt.reshape(-1).long())


def flat(params: Dict) -> Dict[str, torch.Tensor]:
    """The program's nested parameter dict, by leaf name, as float32
    copies that need gradients."""

    out = {"embed": params["embed"], "ln_f": params["ln_f"],
           "unembed": params["unembed"]}
    out.update(params["layers"])
    return {k: out[k].detach().float().clone().requires_grad_(True)
            for k in LEAVES}


def train(model: Dict[str, int], params: Dict, tokens: torch.Tensor,
          steps: int, lr: float, fp8: bool = False
          ) -> Tuple[List[float], List[Dict[str, torch.Tensor]],
                     List[Dict[str, torch.Tensor]]]:
    """``steps`` SGD steps from ``params``: (each step's loss, each step's
    gradients, the parameters before each step and after the last)."""

    p = flat(params)
    losses, grads, states = [], [], [{k: t.detach().clone()
                                      for k, t in p.items()}]
    for _ in range(steps):
        lv = loss(model, p, tokens, fp8)
        g = torch.autograd.grad(lv, list(p.values()))
        with torch.no_grad():
            for t, gi in zip(p.values(), g):
                t.sub_(lr * gi)
        losses.append(lv.item())
        grads.append({k: gi.detach() for k, gi in zip(p, g)})
        states.append({k: t.detach().clone() for k, t in p.items()})
    return losses, grads, states


def norm_gap(got: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor],
             keep: List[str]) -> float:
    """The worst leaf's gap between two sets of norms: |‖got‖ - ‖want‖|
    over the larger of ‖want‖ and the median leaf's ‖want‖, over the
    leaves ``keep``."""

    norms = {k: want[k].double().norm().item() for k in keep}
    med = sorted(norms.values())[len(norms) // 2]
    return max(abs(got[k].double().norm().item() - norms[k])
               / max(norms[k], med) for k in keep)


def diff_gap(got: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor],
             keep: List[str]) -> float:
    """The worst leaf's distance from the reference: ‖got - want‖ over the
    larger of ‖want‖ and the median leaf's ‖want‖, over ``keep``."""

    norms = {k: want[k].double().norm().item() for k in keep}
    med = sorted(norms.values())[len(norms) // 2]
    return max((got[k].double() - want[k].double()).norm().item()
               / max(norms[k], med) for k in keep)


def moving_leaves(grads: Dict[str, torch.Tensor]) -> List[str]:
    """Leaves whose reference gradient is not nought to rounding: at
    least a thousandth of the median leaf's norm."""

    norms = {k: g.double().norm().item() for k, g in grads.items()}
    med = sorted(norms.values())[len(norms) // 2]
    return [k for k in LEAVES if norms[k] >= 1e-3 * med]
