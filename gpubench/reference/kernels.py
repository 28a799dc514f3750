"""Plain versions of the load steps the benchmark's mixes time: the
chained tile products and causal attention, in float32 with TF32 off
(``model.fp32``); with ``fp8=True`` the control, every operand and every
rounded result in float8 e4m3 under a per-tensor scale."""

from __future__ import annotations

import math

import torch

from .model import to_e4m3


def mxu_chain(x: torch.Tensor, w: torch.Tensor, iters: int,
              fp8: bool = False) -> torch.Tensor:
    """``iters`` products ``acc = acc @ w``, each summed in float32 and
    rounded to ``x``'s dtype (bf16), as the step states; the control
    rounds to e4m3 instead."""

    w32 = to_e4m3(w.float()) if fp8 else w.float()
    acc = x.float()
    for _ in range(iters):
        acc = acc @ w32
        acc = to_e4m3(acc) if fp8 else acc.to(x.dtype).float()
    return acc


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     fp8: bool = False, heads_per_block: int = 16
                     ) -> torch.Tensor:
    """Causal softmax attention of (B, S, H, D) tensors, in float32 and
    in blocks of heads; the result in float32."""

    B, S, H, D = q.shape
    out = torch.empty((B, S, H, D), dtype=torch.float32, device=q.device)
    mask = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
    for h0 in range(0, H, heads_per_block):
        hs = slice(h0, min(H, h0 + heads_per_block))
        qb, kb, vb = (t[:, :, hs].float().transpose(1, 2) for t in (q, k, v))
        if fp8:
            qb, kb, vb = to_e4m3(qb), to_e4m3(kb), to_e4m3(vb)
        s = (qb @ kb.transpose(-1, -2)) / math.sqrt(D)
        p = torch.softmax(s.masked_fill(~mask, float("-inf")), dim=-1)
        if fp8:
            p = to_e4m3(p)
        out[:, :, hs] = (p @ vb).transpose(1, 2)
    return out


def max_rms_error(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest element's distance from the reference over the
    reference's RMS."""

    got, want = got.float(), want.float()
    rms = want.square().mean().sqrt().clamp(min=1e-30)
    return ((got - want).abs().max() / rms).item()
