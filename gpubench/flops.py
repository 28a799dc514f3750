"""The yardstick's arithmetic: the chip's peaks, and the operations and
bytes that a step or a kernel call needs, worked out from shapes alone.

Counts follow the on-chip guide's rules: every matrix product is 2*m*n*k;
causal attention counts the S*(S+1)/2 query-key pairs that the mask
keeps; each input byte is read once and each output byte written once,
whatever a kernel reads again.  Nothing here imports the program.
"""

from __future__ import annotations

from typing import Dict, Optional

#: published dense peaks of the H100 SXM (NVIDIA's data sheet, 700 W):
#: bf16 tensor-core FLOP/s and HBM3 bytes/s
PEAKS: Dict[str, Dict[str, float]] = {
    "H100": {"bf16_flops": 989e12, "hbm_bytes_per_s": 3.35e12},
}


def peaks(device_name: str) -> Dict[str, float]:
    """The peaks of the card ``torch.cuda.get_device_name`` names; a card
    not in the table has no roofline, and raises."""

    for key, p in PEAKS.items():
        if key in device_name:
            return p
    raise KeyError(f"no published peaks for {device_name!r}")


def causal_pairs(s: int) -> int:
    """Query-key pairs a causal mask keeps over ``s`` positions."""

    return s * (s + 1) // 2


def attention_fwd_flops(b: int, h: int, s: int, d: int) -> int:
    """Causal attention's forward: Q K^T and P V over the kept pairs."""

    return 2 * (2 * d * causal_pairs(s)) * b * h


def attention_bwd_flops(b: int, h: int, s: int, d: int) -> int:
    """Causal attention's backward, with P kept: dV = P^T dO, dP = dO V^T,
    dQ = dS K, dK = dS^T Q over the kept pairs (no recomputation)."""

    return 4 * (2 * d * causal_pairs(s)) * b * h


def train_step_flops(model: Dict[str, int]) -> int:
    """One SGD step of the bench transformer (``model``: vocab, d_model,
    n_heads, n_layers, d_ff, seq_len, batch): every forward product and
    its two backward ones, causal attention forward and backward.  The
    loss predicts ``seq_len - 1`` next tokens, so that many positions run.
    Norms, GELU, softmax and the update are left out."""

    b, s = model["batch"], model["seq_len"] - 1
    d, f, v = model["d_model"], model["d_ff"], model["vocab"]
    h, layers = model["n_heads"], model["n_layers"]
    rows = b * s
    gemm_per_layer = 2 * rows * (3 * d * d + d * d + 2 * d * f)
    gemm = layers * gemm_per_layer + 2 * rows * d * v
    attn = layers * (attention_fwd_flops(b, h, s, d // h)
                     + attention_bwd_flops(b, h, s, d // h))
    return 3 * gemm + attn


def attention_bytes(b: int, h: int, s: int, d: int, backward: bool,
                    itemsize: int = 2) -> int:
    """Bytes of one attention call: q, k, v in and o out; with the
    backward pass also dO in and dQ, dK, dV out."""

    tensors = 8 if backward else 4
    return tensors * b * h * s * d * itemsize


def mxu_burn_flops(tiles: int, tile: int, iters: int) -> int:
    """``iters`` chained (tile, tile) products on each of ``tiles``."""

    return tiles * iters * 2 * tile ** 3


def mxu_burn_bytes(tiles: int, tile: int, itemsize: int = 2) -> int:
    """x and w in, the result out."""

    return (2 * tiles + 1) * tile * tile * itemsize


def roofline_pct(flops: float, nbytes: float, seconds: float,
                 device_name: str) -> Optional[float]:
    """The least time the card could take (the larger of operations over
    peak FLOP/s and bytes over peak bytes/s) as a share of ``seconds``,
    in %."""

    if seconds <= 0:
        return None
    p = peaks(device_name)
    bound = max(flops / p["bf16_flops"], nbytes / p["hbm_bytes_per_s"])
    return 100.0 * bound / seconds
