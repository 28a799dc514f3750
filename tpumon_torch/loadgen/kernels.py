"""Flash attention for the monitored workload: hand-written CUDA kernels
for Hopper, with a plain PyTorch twin of each.

Counterpart of the flash part of ``tpumon/loadgen/kernels.py``: the same
public contract (:func:`flash_attention` on (B, S, H, D) tensors, folded
to (B*H, S, D), causal tail padding, the non-causal ``ValueError``) and
the same three device kernels, forward, dQ and dK/dV, now in
``tpumon_torch/csrc/flash_attn.cu``.

Each kernel has a wrapper (:func:`flash_fwd`, :func:`flash_bwd_dq`,
:func:`flash_bwd_dkv`).  A wrapper runs its plain version (the
``*_plain`` function beside it) when, and only when, its tensors lie on
the CPU; on a CUDA tensor it launches the kernel or raises.  Every launch
adds one to ``LAUNCHES[<wrapper name>]``, so a run can show that its
attention went through the kernels.

The plain versions walk the same (block_q, block_k) tiles as the Pallas
grid, with the same online-softmax carries (:func:`attention_combine`)
and the same softmax recomputation in the backward pass, all in f32.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from .. import _build

#: kernel launches per wrapper since the counts were last set to 0
LAUNCHES: Dict[str, int] = {"flash_fwd": 0, "flash_bwd_dq": 0,
                            "flash_bwd_dkv": 0}

#: head dims the CUDA kernels are instantiated for
KERNEL_HEAD_DIMS = (64, 128)

#: How far a kernel's output may stand from its plain version's, element
#: by element: |got - want| <= KERNEL_RTOL * |want| + atol, where atol is
#: KERNEL_ATOL_EPS bf16 epsilons (2**-7) of the output's RMS.  Both round
#: their outputs to bf16, which alone can part them by one ulp, at most
#: 2**-7 of |want|.  The kernels also round p and dS to bf16 before the
#: second product of each tile, so an element that sums up to S such
#: products keeps their rounding errors where the sum cancels, as key 0
#: of dK does, which collects from every row.  At 4 epsilons the bench
#: shape's dK failed on an H100 (1.37x the limit, flash_attention against
#: dense attention); at 16 the kernels read a quarter to a third of it.
#: The check holds every element to its own size: a late q row or k
#: tile, whose values are a few hundredths where row 0 of O (= v_0)
#: reaches 4, is not measured against the tensor's largest element.
KERNEL_RTOL = 2e-2
KERNEL_ATOL_EPS = 16


def plain_excess(got: torch.Tensor, want: torch.Tensor) -> float:
    """Largest ``|got - want| / (atol + KERNEL_RTOL * |want|)`` over the
    elements: at most 1 when the kernel output ``got`` is within the
    kernels' tolerance of its plain version ``want``."""

    got, want = got.float(), want.float()
    rms = want.square().mean().sqrt()
    atol = torch.clamp_min(
        KERNEL_ATOL_EPS * torch.finfo(torch.bfloat16).eps * rms,
        torch.finfo(torch.float32).tiny)
    return ((got - want).abs() / (atol + KERNEL_RTOL * want.abs())
            ).max().item()


def attention_combine(q, k, v, m, l, acc, *, scale: float,
                      mask: Optional[torch.Tensor] = None):
    """One online-softmax accumulation step, rank-polymorphic.

    ``q``: (..., sq, D); ``k``/``v``: (..., sk, D); ``m``/``l``:
    (..., sq, 1); ``acc``: (..., sq, D), all f32 carries.  Returns the
    updated (m, l, acc).  A fully-masked tile (running max still -inf)
    stays exact: exp is never taken of -inf - -inf.
    """

    s = torch.einsum("...qd,...kd->...qk", q.float(), k.float()) * scale
    if mask is not None:
        s = s.masked_fill(~mask, float("-inf"))
    m_blk = s.amax(dim=-1, keepdim=True)
    m_new = torch.maximum(m, m_blk)
    m_safe = torch.where(torch.isneginf(m_new), 0.0, m_new)
    p = torch.exp(s - m_safe)
    if mask is not None:
        p = torch.where(mask, p, 0.0)
    corr = torch.exp(torch.where(torch.isneginf(m), m_safe, m) - m_safe)
    corr = torch.where(torch.isneginf(m), 0.0, corr)
    l_new = l * corr + p.sum(dim=-1, keepdim=True)
    acc_new = acc * corr + torch.einsum("...qk,...kd->...qd", p, v.float())
    return m_new, l_new, acc_new


def _causal_tile_mask(i: int, j: int, block_q: int, block_k: int,
                      device) -> torch.Tensor:
    row = i * block_q + torch.arange(block_q, device=device)[:, None]
    col = j * block_k + torch.arange(block_k, device=device)[None, :]
    return row >= col


def _live(causal: bool, i: int, j: int, block_q: int, block_k: int) -> bool:
    # a causal tile computes only if any of it is at or behind the
    # diagonal: last row of the Q tile >= first column of the K tile
    return not causal or (i + 1) * block_q - 1 >= j * block_k


# ---- plain versions (CPU path, and the yardstick on the card) --------------

def flash_fwd_plain(qf, kf, vf, causal: bool, block_q: int, block_k: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Blockwise online-softmax forward on (BH, S, D): returns O (input
    dtype) and the row logsumexp lse (BH, S) f32.  S must divide both
    blocks (:func:`flash_attention` pads to make it so)."""

    BH, S, D = qf.shape
    scale = D ** -0.5
    o = torch.empty_like(qf)
    lse = torch.empty((BH, S), dtype=torch.float32, device=qf.device)
    for i in range(S // block_q):
        rows = slice(i * block_q, (i + 1) * block_q)
        q = qf[:, rows].float()
        m = torch.full((BH, block_q, 1), float("-inf"), device=qf.device)
        l = torch.zeros((BH, block_q, 1), device=qf.device)
        acc = torch.zeros((BH, block_q, D), device=qf.device)
        for j in range(S // block_k):
            if not _live(causal, i, j, block_q, block_k):
                continue
            cols = slice(j * block_k, (j + 1) * block_k)
            mask = (_causal_tile_mask(i, j, block_q, block_k, qf.device)
                    if causal else None)
            m, l, acc = attention_combine(q, kf[:, cols], vf[:, cols], m, l,
                                          acc, scale=scale, mask=mask)
        l_safe = torch.clamp_min(l, 1e-20)
        o[:, rows] = (acc / l_safe).to(qf.dtype)
        lse[:, rows] = (m + torch.log(l_safe))[..., 0]
    return o, lse


def _rebuild_tile(scale: float, causal: bool, i: int, j: int, block_q: int,
                  block_k: int, q, k, v, do, lse, delta):
    """Backward-pass softmax recomputation for score tile (i, j), all f32:
    p = exp(s - lse) from the saved row logsumexp, and dS."""

    s = q @ k.transpose(-1, -2) * scale
    if causal:
        s = s.masked_fill(~_causal_tile_mask(i, j, block_q, block_k, q.device),
                          float("-inf"))
    p = torch.exp(s - lse)                       # exp(-inf) -> 0
    dp = do @ v.transpose(-1, -2)
    ds = p * (dp - delta) * scale
    return p, ds


def _tiles(x, rows):
    return x[:, rows].float()


def flash_bwd_dq_plain(qf, kf, vf, do, lse, delta, causal: bool,
                       block_q: int, block_k: int) -> torch.Tensor:
    """dQ_i = sum_j dS_ij K_j, in the input dtype."""

    BH, S, D = qf.shape
    scale = D ** -0.5
    dq = torch.empty_like(qf)
    for i in range(S // block_q):
        rows = slice(i * block_q, (i + 1) * block_q)
        q, d_o = _tiles(qf, rows), _tiles(do, rows)
        lse_i, delta_i = lse[:, rows, None], delta[:, rows, None]
        acc = torch.zeros((BH, block_q, D), device=qf.device)
        for j in range(S // block_k):
            if not _live(causal, i, j, block_q, block_k):
                continue
            cols = slice(j * block_k, (j + 1) * block_k)
            k = _tiles(kf, cols)
            _, ds = _rebuild_tile(scale, causal, i, j, block_q, block_k, q, k,
                                  _tiles(vf, cols), d_o, lse_i, delta_i)
            acc += ds @ k
        dq[:, rows] = acc.to(qf.dtype)
    return dq


def flash_bwd_dkv_plain(qf, kf, vf, do, lse, delta, causal: bool,
                        block_q: int, block_k: int
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """dV_j = sum_i P_ij^T dO_i and dK_j = sum_i dS_ij^T Q_i, in the
    input dtype."""

    BH, S, D = qf.shape
    scale = D ** -0.5
    dk, dv = torch.empty_like(kf), torch.empty_like(vf)
    for j in range(S // block_k):
        cols = slice(j * block_k, (j + 1) * block_k)
        k, v = _tiles(kf, cols), _tiles(vf, cols)
        dk_acc = torch.zeros((BH, block_k, D), device=qf.device)
        dv_acc = torch.zeros((BH, block_k, D), device=qf.device)
        for i in range(S // block_q):
            if not _live(causal, i, j, block_q, block_k):
                continue
            rows = slice(i * block_q, (i + 1) * block_q)
            q, d_o = _tiles(qf, rows), _tiles(do, rows)
            p, ds = _rebuild_tile(scale, causal, i, j, block_q, block_k, q, k,
                                  v, d_o, lse[:, rows, None],
                                  delta[:, rows, None])
            dv_acc += p.transpose(-1, -2) @ d_o
            dk_acc += ds.transpose(-1, -2) @ q
        dk[:, cols] = dk_acc.to(kf.dtype)
        dv[:, cols] = dv_acc.to(vf.dtype)
    return dk, dv


# ---- kernel wrappers ---------------------------------------------------------

def _on_cpu(*ts: torch.Tensor) -> bool:
    devs = {t.device.type for t in ts}
    if devs == {"cpu"}:
        return True
    if devs != {"cuda"} or len({t.device for t in ts}) != 1:
        raise ValueError(f"flash attention needs all tensors on one CUDA "
                         f"device or all on the CPU, got {sorted(devs)}")
    return False


def _kernel_args(name: str, halves, floats=()):
    """Validate kernel inputs (raise on what the kernel does not take)
    and return the library and the launch's stream."""

    BH, S, D = halves[0].shape
    if D not in KERNEL_HEAD_DIMS:
        raise ValueError(f"{name}: head dim {D} has no kernel "
                         f"(built for {KERNEL_HEAD_DIMS})")
    if not 0 < BH <= 65535:
        raise ValueError(f"{name}: B*H={BH} outside the kernel's grid")
    for t in halves:
        if t.dtype != torch.bfloat16 or t.shape != (BH, S, D):
            raise ValueError(f"{name}: want bf16 {(BH, S, D)}, got "
                             f"{t.dtype} {tuple(t.shape)}")
    for t in floats:
        if t.dtype != torch.float32 or t.shape != (BH, S):
            raise ValueError(f"{name}: want f32 {(BH, S)}, got "
                             f"{t.dtype} {tuple(t.shape)}")
    for t in (*halves, *floats):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: inputs must be contiguous and "
                             f"16-byte aligned")
    return _build.load(), torch.cuda.current_stream(halves[0].device).cuda_stream


def flash_fwd(qf, kf, vf, causal: bool, block_q: int, block_k: int
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward on (BH, S, D): (O, lse).  Kernel on CUDA (bf16), plain
    version on the CPU.  The kernel tiles by 64 whatever the blocks."""

    if _on_cpu(qf, kf, vf):
        return flash_fwd_plain(qf, kf, vf, causal, block_q, block_k)
    lib, stream = _kernel_args("flash_fwd", (qf, kf, vf))
    BH, S, D = qf.shape
    o = torch.empty_like(qf)
    lse = torch.empty((BH, S), dtype=torch.float32, device=qf.device)
    with torch.cuda.device(qf.device):
        _build.check(lib.tpumon_flash_fwd(
            qf.data_ptr(), kf.data_ptr(), vf.data_ptr(), o.data_ptr(),
            lse.data_ptr(), BH, S, D, int(causal), D ** -0.5, stream),
            "flash_fwd")
    LAUNCHES["flash_fwd"] += 1
    return o, lse


def flash_bwd_dq(qf, kf, vf, do, lse, delta, causal: bool, block_q: int,
                 block_k: int) -> torch.Tensor:
    """dQ on (BH, S, D).  Kernel on CUDA, plain version on the CPU."""

    if _on_cpu(qf, kf, vf, do, lse, delta):
        return flash_bwd_dq_plain(qf, kf, vf, do, lse, delta, causal,
                                  block_q, block_k)
    lib, stream = _kernel_args("flash_bwd_dq", (qf, kf, vf, do),
                               (lse, delta))
    BH, S, D = qf.shape
    dq = torch.empty_like(qf)
    with torch.cuda.device(qf.device):
        _build.check(lib.tpumon_flash_bwd_dq(
            qf.data_ptr(), kf.data_ptr(), vf.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), BH, S, D,
            int(causal), D ** -0.5, stream), "flash_bwd_dq")
    LAUNCHES["flash_bwd_dq"] += 1
    return dq


def flash_bwd_dkv(qf, kf, vf, do, lse, delta, causal: bool, block_q: int,
                  block_k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dK, dV) on (BH, S, D).  Kernel on CUDA, plain version on the
    CPU."""

    if _on_cpu(qf, kf, vf, do, lse, delta):
        return flash_bwd_dkv_plain(qf, kf, vf, do, lse, delta, causal,
                                   block_q, block_k)
    lib, stream = _kernel_args("flash_bwd_dkv", (qf, kf, vf, do),
                               (lse, delta))
    BH, S, D = qf.shape
    dk, dv = torch.empty_like(kf), torch.empty_like(vf)
    with torch.cuda.device(qf.device):
        _build.check(lib.tpumon_flash_bwd_dkv(
            qf.data_ptr(), kf.data_ptr(), vf.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            BH, S, D, int(causal), D ** -0.5, stream), "flash_bwd_dkv")
    LAUNCHES["flash_bwd_dkv"] += 1
    return dk, dv


class _Flash3(torch.autograd.Function):
    """Forward kernel paired with the dQ and dK/dV kernels, which rebuild
    the softmax tiles from the saved row logsumexp (recomputation, not
    storage of the score matrix)."""

    @staticmethod
    def forward(ctx, qf, kf, vf, causal, block_q, block_k):
        o, lse = flash_fwd(qf, kf, vf, causal, block_q, block_k)
        ctx.save_for_backward(qf, kf, vf, o, lse)
        ctx.blocks = (causal, block_q, block_k)
        return o

    @staticmethod
    def backward(ctx, do):
        qf, kf, vf, o, lse = ctx.saved_tensors
        causal, block_q, block_k = ctx.blocks
        do = do.contiguous()
        # delta_i = rowsum(dO_i * O_i): the dP -> dS softmax-jacobian term
        delta = (do.float() * o.float()).sum(dim=-1)
        dq = flash_bwd_dq(qf, kf, vf, do, lse, delta, causal, block_q,
                          block_k)
        dk, dv = flash_bwd_dkv(qf, kf, vf, do, lse, delta, causal, block_q,
                               block_k)
        return dq, dk, dv, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, block_q: int = 128,
                    block_k: int = 128) -> torch.Tensor:
    """Blocked flash attention, (B, S, H, D) -> (B, S, H, D).

    Differentiable: the backward pass runs the dQ and dK/dV kernels.  A
    sequence that does not divide the blocks is zero-padded at its tail
    when causal (padded keys sit in every real query's future, padded
    query rows are sliced off) with both blocks set to the smaller one;
    non-causal attention refuses it with ``ValueError``.
    """

    B, S, H, D = q.shape
    block_q = min(block_q, S)
    block_k = min(block_k, S)
    S_pad = S
    if S % block_q or S % block_k:
        if not causal:
            raise ValueError(
                f"seq len {S} not divisible by blocks "
                f"({block_q},{block_k}); automatic padding is only exact "
                "for causal attention")
        block_q = block_k = min(block_q, block_k)
        S_pad = (S + block_q - 1) // block_q * block_q
        q, k, v = (F.pad(x, (0, 0, 0, 0, 0, S_pad - S)) for x in (q, k, v))

    def fold(x):
        return x.transpose(1, 2).reshape(B * H, S_pad, D)

    out = _Flash3.apply(fold(q), fold(k), fold(v), causal, block_q, block_k)
    out = out.reshape(B, H, S_pad, D).transpose(1, 2)
    return out[:, :S] if S_pad != S else out
