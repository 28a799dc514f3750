"""The loadgen's device kernels: flash attention for the monitored
workload, the two load-shaping kernels and the train step's fused SGD
update, each hand-written in CUDA for Hopper with a plain PyTorch twin;
and the load patterns built on them.

Counterpart of ``tpumon/loadgen/kernels.py``: the same public contracts
(:func:`flash_attention` on (B, S, H, D) tensors, folded to (B*H, S, D),
causal tail padding, the non-causal ``ValueError``; :func:`mxu_burn` on
square bf16 tiles; :func:`hbm_stream` over (256, 1024) blocks with its
divisibility check; :func:`make_pattern`) and the same five device
kernels: flash forward, dQ and dK/dV in
``tpumon_torch/csrc/flash_attn.cu``, the tensor-core burn and the memory
stream in ``tpumon_torch/csrc/load_kernels.cu``.  One more kernel has no
Pallas counterpart: :func:`sgd_update` (``tpumon_torch/csrc/sgd_update.cu``),
the update that XLA fuses into the reference's jitted train step.

Each kernel has a wrapper (:func:`flash_fwd`, :func:`flash_bwd_dq`,
:func:`flash_bwd_dkv`, :func:`mxu_burn`, :func:`hbm_stream`,
:func:`sgd_update`).  A wrapper
runs its plain version (the ``*_plain`` function beside it) when, and
only when, its tensors lie on the CPU; on a CUDA tensor it launches the
kernel or raises.  Every launch adds one to ``LAUNCHES[<wrapper name>]``,
so a run can show that its work went through the kernels.

The plain flash versions walk the same (block_q, block_k) tiles as the
Pallas grid, with the same online-softmax carries
(:func:`attention_combine`) and the same softmax recomputation in the
backward pass, all in f32.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from .. import _build

#: kernel launches per wrapper since the counts were last set to 0
LAUNCHES: Dict[str, int] = {"flash_fwd": 0, "flash_bwd_dq": 0,
                            "flash_bwd_dkv": 0, "mxu_burn": 0,
                            "hbm_stream": 0, "sgd_update": 0}

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

def _on_cpu(*ts: torch.Tensor, name: str = "flash attention") -> bool:
    devs = {t.device.type for t in ts}
    if devs == {"cpu"}:
        return True
    if devs != {"cuda"} or len({t.device for t in ts}) != 1:
        raise ValueError(f"{name} needs all tensors on one CUDA device or "
                         f"all on the CPU, got {sorted(devs)}")
    return False


def _launchable(name: str, *ts: torch.Tensor) -> None:
    for t in ts:
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: inputs must be contiguous and "
                             f"16-byte aligned")


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
    _launchable(name, *halves, *floats)
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
        # at B=1 reshape may return a strided view instead of a copy; the
        # kernels take contiguous heads
        return x.transpose(1, 2).reshape(B * H, S_pad, D).contiguous()

    out = _Flash3.apply(fold(q), fold(k), fold(v), causal, block_q, block_k)
    out = out.reshape(B, H, S_pad, D).transpose(1, 2)
    return out[:, :S] if S_pad != S else out


# ---- load-shaping kernels ------------------------------------------------------

#: the reference's tile and stream block (tpumon/loadgen/kernels.py)
MXU_TILE = 256
STREAM_BLOCK = (256, 1024)
#: rows of a tile that one block of the mxu kernel owns
MXU_BLOCK_ROWS = 128


#: How far mxu_burn's kernel may stand from its plain version, element by
#: element: |got - want| <= 2**-7 * |want| + atol, where atol is
#: MXU_ATOL_EPS * sqrt(iters) bf16 unit roundoffs (2**-8) of the output's
#: RMS.  Both sum exact products of bf16 values in f32, in different
#: orders, and round each step's sums to bf16.  Where two sums straddle a
#: rounding boundary the chains part by one ulp of that element, at most
#: 2**-7 of it: the first term.  From then on each step adds its own
#: rounding error to each chain, which an orthogonal w carries forward
#: without growth: once wholly parted, after t steps they differ by about
#: sqrt(2t/3) * 2**-8 * RMS per element, and the largest of 4.3M such
#: elements (66 tiles of 256 x 256) sits near 5.2 of those, 0.13 RMS at
#: t=64.  At 8 atol is 0.25 RMS there, about twice that; f64 against f32
#: sums on the CPU parted by 0.078 RMS at most over 16 tiles, 64 steps.  A
#: chain one step short reads ~1.4 RMS off.  The inputs must keep the
#: chain bounded (w orthogonal): the pattern's own random w overflows bf16
#: within one call.
MXU_ATOL_EPS = 8


def mxu_excess(got: torch.Tensor, want: torch.Tensor, iters: int) -> float:
    """Largest ``|got - want|`` over its limit (see MXU_ATOL_EPS): at
    most 1 when the kernel's chain is within tolerance of the plain
    version's."""

    got, want = got.float(), want.float()
    atol = (MXU_ATOL_EPS * iters ** 0.5 * 2.0 ** -8
            * want.square().mean().sqrt())
    return ((got - want).abs() / (atol + 2.0 ** -7 * want.abs())
            ).max().item()


def mxu_burn_plain(x: torch.Tensor, w: torch.Tensor, *,
                   iters: int = 64) -> torch.Tensor:
    """``iters`` chained products ``acc = acc @ w``, each summed in f32
    and rounded back to the input dtype, as the Pallas body does."""

    acc = x
    for _ in range(iters):
        acc = (acc.float() @ w.float()).to(x.dtype)
    return acc


def mxu_burn(x: torch.Tensor, w: torch.Tensor, *,
             iters: int = 64) -> torch.Tensor:
    """Chained matmuls of square bf16 tiles: (T, T) x, or (n, T, T) x of
    n independent chains, through one (T, T) w.  Kernel on CUDA (T of
    256, the reference's tile), plain version on the CPU.

    FLOPs ~= n * iters * 2 * T^3 with one read of x and w and one write
    of the result: compute intensity scales linearly with ``iters``.
    """

    if (w.ndim != 2 or w.shape[0] != w.shape[1] or x.ndim not in (2, 3)
            or x.shape[-2:] != w.shape):
        raise ValueError(f"mxu_burn: square tiles, got x {tuple(x.shape)} "
                         f"and w {tuple(w.shape)}")
    if _on_cpu(x, w, name="mxu_burn"):
        return mxu_burn_plain(x, w, iters=iters)
    T = w.shape[0]
    n = x.shape[0] if x.ndim == 3 else 1
    if T != MXU_TILE:
        raise ValueError(f"mxu_burn: tile {T} has no kernel (built for "
                         f"{MXU_TILE})")
    if x.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise ValueError(f"mxu_burn: want bf16, got {x.dtype} and {w.dtype}")
    if not 0 < n <= 65535:
        raise ValueError(f"mxu_burn: {n} tiles outside the kernel's grid")
    _launchable("mxu_burn", x, w)
    o = torch.empty_like(x)
    with torch.cuda.device(x.device):
        _build.check(_build.load().tpumon_mxu_burn(
            x.data_ptr(), w.data_ptr(), o.data_ptr(), n, iters,
            torch.cuda.current_stream().cuda_stream), "mxu_burn")
    LAUNCHES["mxu_burn"] += 1
    return o


def _stream_blocks(x: torch.Tensor) -> None:
    """The reference's block contract: (256, 1024) blocks clipped to the
    shape must tile it exactly."""

    if x.ndim != 2 or x.numel() == 0:
        raise ValueError(f"hbm_stream: want a non-empty (rows, cols) array, "
                         f"got {tuple(x.shape)}")
    rows, cols = x.shape
    br, bc = min(STREAM_BLOCK[0], rows), min(STREAM_BLOCK[1], cols)
    if rows % br or cols % bc:
        raise ValueError(f"shape {tuple(x.shape)} not divisible by block "
                         f"({br},{bc})")


def hbm_stream_plain(x: torch.Tensor) -> torch.Tensor:
    """``x * 1.0001 + 0.25``: one multiply-add per element, any dtype."""

    return x * 1.0001 + 0.25


def hbm_stream(x: torch.Tensor) -> torch.Tensor:
    """Elementwise pass that reads and writes every byte of ``x`` once.
    Kernel on CUDA (f32, bit for bit the plain version), plain version
    on the CPU."""

    _stream_blocks(x)
    if _on_cpu(x, name="hbm_stream"):
        return hbm_stream_plain(x)
    if x.dtype != torch.float32:
        raise ValueError(f"hbm_stream: want f32, got {x.dtype}")
    _launchable("hbm_stream", x)
    o = torch.empty_like(x)
    with torch.cuda.device(x.device):
        _build.check(_build.load().tpumon_hbm_stream(
            x.data_ptr(), o.data_ptr(), x.numel(),
            torch.cuda.current_stream().cuda_stream), "hbm_stream")
    LAUNCHES["hbm_stream"] += 1
    return o


# ---- the train step's update ----------------------------------------------------

#: leaves one :func:`sgd_update` launch takes (its kernel's table)
SGD_MAX_LEAVES = 64


def sgd_update_plain(masters: Sequence[torch.Tensor],
                     grads: Sequence[torch.Tensor],
                     works: Sequence[torch.Tensor], lr: float) -> None:
    """The f32 SGD update of every master ``t`` by its bf16 gradient
    ``g``, then its bf16 working copy ``w`` refreshed from it, in place:
    :func:`..model._sgd` followed by the forward's cast."""

    for t, g, w in zip(masters, grads, works):
        t.copy_(t - lr * g.float())
        w.copy_(t.to(torch.bfloat16))


def sgd_update(masters: Sequence[torch.Tensor],
               grads: Sequence[torch.Tensor],
               works: Sequence[torch.Tensor], lr: float) -> None:
    """:func:`sgd_update_plain` over every leaf: ``masters`` f32,
    ``grads`` and ``works`` bf16 of the masters' shapes, all contiguous.
    One kernel launch on CUDA, whatever the number of leaves (at most
    :data:`SGD_MAX_LEAVES`), bit for bit the plain version; the plain
    version on the CPU.  Reads each master and gradient once and writes
    each master and working copy once: 12 bytes an element."""

    masters, grads, works = list(masters), list(grads), list(works)
    if not masters or not len(masters) == len(grads) == len(works):
        raise ValueError(f"sgd_update: want as many gradients and working "
                         f"copies as masters (at least one), got "
                         f"{len(masters)}, {len(grads)}, {len(works)}")
    for i, (t, g, w) in enumerate(zip(masters, grads, works)):
        if (t.dtype, g.dtype, w.dtype) != (torch.float32, torch.bfloat16,
                                           torch.bfloat16):
            raise ValueError(f"sgd_update: leaf {i}: want an f32 master, a "
                             f"bf16 gradient and a bf16 copy, got {t.dtype}, "
                             f"{g.dtype}, {w.dtype}")
        if not t.shape == g.shape == w.shape or t.numel() == 0:
            raise ValueError(f"sgd_update: leaf {i}: want one non-empty "
                             f"shape, got {tuple(t.shape)}, "
                             f"{tuple(g.shape)}, {tuple(w.shape)}")
        if not (t.is_contiguous() and g.is_contiguous()
                and w.is_contiguous()):
            raise ValueError(f"sgd_update: leaf {i}: not contiguous")
    if _on_cpu(*masters, *grads, *works, name="sgd_update"):
        with torch.no_grad():
            sgd_update_plain(masters, grads, works, lr)
        return
    n = len(masters)
    if n > SGD_MAX_LEAVES:
        raise ValueError(f"sgd_update: {n} leaves, the kernel takes "
                         f"{SGD_MAX_LEAVES}")
    ptrs = [(ctypes.c_void_p * n)(*(t.data_ptr() for t in ts))
            for ts in (masters, grads, works)]
    sizes = (ctypes.c_longlong * n)(*(t.numel() for t in masters))
    with torch.cuda.device(masters[0].device):
        _build.check(_build.load().tpumon_sgd_update(
            *(ctypes.addressof(p) for p in ptrs), ctypes.addressof(sizes), n,
            lr, torch.cuda.current_stream().cuda_stream), "sgd_update")
    LAUNCHES["sgd_update"] += 1


# ---- load patterns ---------------------------------------------------------------

PATTERNS = ("mxu", "hbm", "mixed", "flash", "conv")
#: ``hbm`` pattern shape: the reference's (2048, 4096) f32 on the CPU; on
#: a card a size that device memory, not the 50 MB L2, has to serve
HBM_SHAPE = {"cpu": (2048, 4096), "cuda": (16384, 4096)}
#: ``flash`` (B, S, H, D) and ``conv`` (B, HW, C): the reference's
#: interpret sizes on the CPU; on a card the reference's chip sizes, but
#: for ``flash`` 192 heads where the reference has 4: at 4 the forward
#: kernel takes a fifth of the host's time per step, at 192 over twice it,
#: so the card, not the host, sets the pace (on an H100; PERF.md, Findings)
FLASH_SHAPE = {"cpu": (1, 64, 2, 8), "cuda": (1, 1024, 192, 128)}
CONV_SHAPE = {"cpu": (1, 16, 8), "cuda": (8, 128, 128)}


def _randn(shape, seed: int, device, dtype=torch.bfloat16) -> torch.Tensor:
    g = torch.Generator(device).manual_seed(seed)
    return torch.randn(shape, generator=g, device=device).to(dtype)


def mxu_tiles(device) -> int:
    """Tiles the ``mxu`` pattern burns at once: the reference's one on
    the CPU; on a card enough for one block on every SM (a 256 tile
    splits into two blocks of 128 rows, and one block fills an SM's
    shared memory)."""

    device = torch.device(device)
    if device.type != "cuda":
        return 1
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return -(-sms // (MXU_TILE // MXU_BLOCK_ROWS))


def conv_step(a: torch.Tensor, ws) -> torch.Tensor:
    """Three 'SAME' 3x3 convolutions (bf16 in and out, f32 sums), then
    the reference's RMS renormalisation so the loop sustains forever.
    ``a`` is (B, C, H, W) in channels_last memory: NHWC, as the
    reference lays it out."""

    for w in ws:
        a = F.conv2d(a, w, padding=1)
    scale = torch.sqrt(a.float().square().mean() + 1e-6)
    return (a.float() / scale).to(torch.bfloat16)


def conv_weights(hwio) -> list:
    """(3, 3, C, C) HWIO filters as the reference holds them -> conv2d's
    (C_out, C_in, 3, 3), in channels_last memory like the activations."""

    return [w.permute(3, 2, 0, 1).contiguous(
        memory_format=torch.channels_last) for w in hwio]


def make_pattern(pattern: str, *, device="cuda"):
    """Return (step_fn, state) producing sustained load of the given shape
    on ``device``.

    ``mxu``: tensor-core duty (:func:`mxu_burn`); ``hbm``: device-memory
    bandwidth (:func:`hbm_stream`); ``mixed``: the two alternating;
    ``flash``: causal flash attention forward, its output fed back as Q;
    ``conv``: a CNN forward on ``torch.nn.functional.conv2d`` (the
    reference runs plain XLA convolutions here, no Pallas kernel).
    """

    device = torch.device(device)
    kind = "cuda" if device.type == "cuda" else "cpu"
    if pattern == "mxu":
        n = mxu_tiles(device)
        shape = (n, MXU_TILE, MXU_TILE) if n > 1 else (MXU_TILE, MXU_TILE)
        # random normal x and w as the reference's: at width 256 the chain
        # grows ~16x a product and leaves the bf16 range within the first
        # call, after which it steps on inf/NaN, as the reference does
        x = _randn(shape, 0, device)
        w = _randn((MXU_TILE, MXU_TILE), 1, device)

        def step(state):
            return mxu_burn(state, w, iters=64)

        return step, x
    if pattern == "hbm":
        big = _randn(HBM_SHAPE[kind], 0, device, torch.float32)
        return hbm_stream, big
    if pattern == "flash":
        B, S, H, D = FLASH_SHAPE[kind]
        q, k, v = (_randn((B, S, H, D), seed, device) for seed in range(3))

        def step(state):
            q_cur, k_cur, v_cur = state
            with torch.no_grad():
                out = flash_attention(q_cur, k_cur, v_cur, causal=True)
            # feed the output back as Q to keep steps data-dependent
            return (out, k_cur, v_cur)

        return step, (q, k, v)
    if pattern == "conv":
        B, HW, C = CONV_SHAPE[kind]
        x = _randn((B, HW, HW, C), 0, device).permute(0, 3, 1, 2)
        ws = conv_weights(_randn((3, 3, C, C), seed, device, torch.float32)
                          .div(3.0 * C ** 0.5).to(torch.bfloat16)
                          for seed in (1, 2, 3))
        return (lambda a: conv_step(a, ws)), x
    if pattern == "mixed":
        mxu_step, mxu_state = make_pattern("mxu", device=device)
        hbm_step, hbm_state = make_pattern("hbm", device=device)

        def step(s):
            a, b, i = s
            if i % 2 == 0:
                a = mxu_step(a)
            else:
                b = hbm_step(b)
            return (a, b, i + 1)

        return step, (mxu_state, hbm_state, 0)
    raise ValueError(
        f"unknown pattern {pattern!r} (mxu|hbm|mixed|flash|conv)")
