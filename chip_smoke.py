#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

1. Prints the card's name and power limit (``nvidia-smi``) and builds the
   port's CUDA kernels from ``tpumon_torch/csrc`` (``nvcc``, at first use).
2. Holds each flash-attention kernel (forward, dQ, dK/dV) against its
   plain PyTorch version at the bench shapes (B*H=64, D=128, bf16): causal
   at S=255 padded to 256, as the model's loss runs it, and non-causal at
   S=256.  Tolerance (``kernels.plain_excess``): every element within 2%
   of its own magnitude plus 16 bf16 epsilons of the output's RMS (the
   kernels round p and dS to bf16 between their two tile products; the
   plain versions stay in f32).  The same check must fail planted faults
   built from the kernels' outputs (the last key tile skipped).  Times the
   kernel, the plain version and ``scaled_dot_product_attention``
   (forward, and backward for the two gradient kernels) as the library
   yardstick, which the port never calls.
3. Holds ``flash_attention`` forward and backward, the model's entry to
   the kernels, against dense f32 attention at the bench shape (same
   tolerance), and one bench train step with flash against one of the
   dense model: the q, k, v and o projections' updates (relative
   Frobenius error at most ``UPDATE_RTOL``) and the loss (rtol 2e-2, the
   JAX package's own check).
4. Sets the launch counts to 0, drives the main path in-process —
   ``tpumon_torch.loadgen.run --size bench --self-monitor --seconds 10`` —
   and fails unless the loss is finite, steps ran, families were
   non-blank (HBM used and total among them) and every kernel launched.
5. Prints one ``{"kernels": [...]}`` line, then, last, the
   ``{"ok": true, "device": {...}}`` line.

Exits non-zero, printing no result, on any failure, when CUDA is not
available, or when the ``tpumon_torch`` package is not beside it.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

#: NVIDIA H100 SXM data-sheet peaks (dense bf16 tensor-core rate, HBM3
#: bandwidth) for the roofline bound
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12
#: flash vs dense train step: relative Frobenius error of the update of
#: each attention projection (q, k, v, o).  bf16 activations through two
#: layers part the two models' updates by about 1% (1.2% at most with the
#: plain flash version on the CPU); there, a dK/dV that skipped the last
#: key tile moved the k projection's update by 18%, and a dQ whose last
#: 64 rows were scaled by 0.9 moved the q projection's by 5%.
UPDATE_RTOL = 3e-2

BH, HEADS, D = 64, 8, 128
KERNELS = (
    ("flash_fwd", "_flash_kernel", "tpumon/loadgen/kernels.py:122"),
    ("flash_bwd_dq", "_flash_bwd_dq_kernel", "tpumon/loadgen/kernels.py:192"),
    ("flash_bwd_dkv", "_flash_bwd_dkv_kernel",
     "tpumon/loadgen/kernels.py:219"),
)


def fail(msg: str) -> int:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    return 1


def time_ms(fn, iters: int) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls (CUDA
    events), after one warm-up call."""

    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def max_err(got, want) -> float:
    return (got.float() - want.float()).abs().max().item()


def check_close(K, name: str, got, want) -> float:
    """Fails unless ``got`` is within the kernels' elementwise tolerance
    of ``want``; returns the largest error over its limit (<= 1)."""

    excess = K.plain_excess(got, want)
    if not excess <= 1.0:
        raise AssertionError(f"{name}: |kernel - plain| reaches {excess:.3g}x "
                             f"its elementwise limit (max abs err "
                             f"{max_err(got, want):.3e})")
    return excess


def planted_faults(K, q, k, v, outs, wants) -> dict:
    """The check must fail what a kernel that skipped its last key tile
    would give: O's last 64 rows over the keys before that tile only,
    and zero dK and dV for its keys.  Returns each fault's excess."""

    last = q.shape[1] - 64
    o = outs["o"].clone()
    s = q[:, last:].float() @ k[:, :last].float().mT * D ** -0.5
    o[:, last:] = (s.softmax(-1) @ v[:, :last].float()).to(o.dtype)
    faults = {"o": o}
    for name in ("dk", "dv"):
        faults[name] = outs[name].clone()
        faults[name][:, last:] = 0
    excess = {name: K.plain_excess(t, wants[name])
              for name, t in faults.items()}
    for name, x in excess.items():
        if not x > 1.0:
            raise AssertionError(f"the check passes a planted fault in "
                                 f"{name} (excess {x:.3g})")
    return excess


def bench_inputs(causal: bool):
    """Folded (BH, S, D) bf16 q, k, v, dO as the main path hands them to
    the kernels: causal at S=255 zero-padded to 256 by the public
    ``flash_attention`` contract, non-causal at S=256."""

    import torch
    import torch.nn.functional as F

    g = torch.Generator("cuda").manual_seed(7 if causal else 8)
    S = 255 if causal else 256
    x = [torch.randn((BH // HEADS, S, HEADS, D), generator=g, device="cuda")
         .to(torch.bfloat16) for _ in range(4)]
    if causal:
        x = [F.pad(t, (0, 0, 0, 0, 0, 1)) for t in x]
    return [t.transpose(1, 2).reshape(BH, 256, D).contiguous() for t in x]


def kernel_cases(K, lib):
    """Compare, time and bound the three kernels.  Returns the rows of
    the kernels line (without the launch counts)."""

    import torch
    import torch.nn.functional as F
    from tpumon_torch import _build

    rows = {}
    for causal in (True, False):
        q, k, v, do = bench_inputs(causal)
        S = q.shape[1]
        blk = 128
        o, lse = K.flash_fwd(q, k, v, causal, blk, blk)
        torch.cuda.synchronize()
        o_p, lse_p = K.flash_fwd_plain(q, k, v, causal, blk, blk)
        delta = (do.float() * o_p.float()).sum(-1)
        dq = K.flash_bwd_dq(q, k, v, do, lse_p, delta, causal, blk, blk)
        torch.cuda.synchronize()
        dk, dv = K.flash_bwd_dkv(q, k, v, do, lse_p, delta, causal, blk, blk)
        torch.cuda.synchronize()
        dq_p = K.flash_bwd_dq_plain(q, k, v, do, lse_p, delta, causal, blk,
                                    blk)
        dk_p, dv_p = K.flash_bwd_dkv_plain(q, k, v, do, lse_p, delta, causal,
                                           blk, blk)
        outs = {"o": o, "dq": dq, "dk": dk, "dv": dv}
        wants = {"o": o_p, "dq": dq_p, "dk": dk_p, "dv": dv_p}
        excess = {n: check_close(K, f"{n} ({'' if causal else 'non-'}causal)",
                                 outs[n], wants[n]) for n in outs}
        if max_err(lse, lse_p) > 1e-2:
            raise AssertionError(f"flash_fwd lse off by {max_err(lse, lse_p)}")
        # (max abs error, tolerance excess) of each kernel's outputs
        errs = {name: (max(max_err(outs[n], wants[n]) for n in ns),
                       max(excess[n] for n in ns))
                for name, ns in (("flash_fwd", ("o",)),
                                 ("flash_bwd_dq", ("dq",)),
                                 ("flash_bwd_dkv", ("dk", "dv")))}
        if not causal:
            for name, (err, exc) in errs.items():
                rows[name]["max_abs_err_noncausal"] = err
                rows[name]["tol_excess_noncausal"] = exc
            continue
        print("planted faults rejected, excess: " + json.dumps(
            planted_faults(K, q, k, v, outs, wants)))

        # timings at the main path's (causal, padded) shape
        ptr = [t.data_ptr() for t in (q, k, v, do)]
        scale = D ** -0.5
        stream = torch.cuda.current_stream().cuda_stream
        o_b, lse_b = torch.empty_like(q), torch.empty((BH, S), device="cuda")
        dq_b, dk_b, dv_b = (torch.empty_like(q) for _ in range(3))
        # the kernels alone: their C entry points called back to back,
        # so the host's per-call Python work never gaps the device
        raw = {
            "flash_fwd": lambda: _build.check(lib.tpumon_flash_fwd(
                *ptr[:3], o_b.data_ptr(), lse_b.data_ptr(), BH, S, D, 1,
                scale, stream), "flash_fwd"),
            "flash_bwd_dq": lambda: _build.check(lib.tpumon_flash_bwd_dq(
                *ptr, lse_p.data_ptr(), delta.data_ptr(), dq_b.data_ptr(),
                BH, S, D, 1, scale, stream), "flash_bwd_dq"),
            "flash_bwd_dkv": lambda: _build.check(lib.tpumon_flash_bwd_dkv(
                *ptr, lse_p.data_ptr(), delta.data_ptr(), dk_b.data_ptr(),
                dv_b.data_ptr(), BH, S, D, 1, scale, stream),
                "flash_bwd_dkv"),
        }
        wrapped = {
            "flash_fwd": lambda: K.flash_fwd(q, k, v, True, blk, blk),
            "flash_bwd_dq": lambda: K.flash_bwd_dq(
                q, k, v, do, lse_p, delta, True, blk, blk),
            "flash_bwd_dkv": lambda: K.flash_bwd_dkv(
                q, k, v, do, lse_p, delta, True, blk, blk),
        }
        plain = {
            "flash_fwd": lambda: K.flash_fwd_plain(q, k, v, True, blk, blk),
            "flash_bwd_dq": lambda: K.flash_bwd_dq_plain(
                q, k, v, do, lse_p, delta, True, blk, blk),
            "flash_bwd_dkv": lambda: K.flash_bwd_dkv_plain(
                q, k, v, do, lse_p, delta, True, blk, blk),
        }
        # library yardstick: SDPA on the same (B, H, S, D) data
        q4, k4, v4, do4 = (t.reshape(BH // HEADS, HEADS, S, D)
                           for t in (q, k, v, do))
        qg, kg, vg = (t.detach().clone().requires_grad_() for t in (q4, k4, v4))
        out4 = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True)
        lib_fwd = time_ms(lambda: F.scaled_dot_product_attention(
            q4, k4, v4, is_causal=True), 200)
        lib_bwd = time_ms(lambda: torch.autograd.grad(
            out4, (qg, kg, vg), do4, retain_graph=True), 200)

        # roofline bound from this run's inputs: bytes each input read
        # once and each output written once; tensor-core FLOPs over the
        # (i, j) pairs the causal mask keeps
        half = BH * S * D * 2
        rowvec = BH * S * 4
        pairs = BH * S * (S + 1) // 2
        work = {
            "flash_fwd": (3 * half + half + rowvec, 2 * 2 * D * pairs),
            "flash_bwd_dq": (4 * half + 2 * rowvec + half, 3 * 2 * D * pairs),
            "flash_bwd_dkv": (4 * half + 2 * rowvec + 2 * half,
                              4 * 2 * D * pairs),
        }
        kernel_ms = {name: time_ms(raw[name], 200) for name in raw}
        for name, tpu_kernel, replaces in KERNELS:
            nbytes, flops = work[name]
            t_bytes = nbytes / PEAK_HBM_BYTES * 1e3
            t_ops = flops / PEAK_BF16_FLOPS * 1e3
            rows[name] = {
                "name": name,
                "route": "cuda",
                "source": "tpumon_torch/csrc/flash_attn.cu",
                "replaces": f"{replaces} ({tpu_kernel})",
                "max_abs_err": errs[name][0],
                "tol_excess": errs[name][1],
                "ms": kernel_ms[name],
                "kernel_ms": kernel_ms[name],
                "wrapper_ms": time_ms(wrapped[name], 200),
                "plain_ms": time_ms(plain[name], 20),
                "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "library_ms": lib_fwd if name == "flash_fwd" else lib_bwd,
                "library_call": ("scaled_dot_product_attention forward"
                                 if name == "flash_fwd" else
                                 "scaled_dot_product_attention backward "
                                 "(dQ, dK and dV together)"),
            }
    return rows


def attention_check(K) -> dict:
    """``flash_attention`` forward and backward, as the model calls it
    (B=8, S=255 padded to 256, 8 heads of 128, causal, bf16), against
    dense f32 attention on the same inputs, element by element with the
    kernels' tolerance.  The dense backward takes delta = rowsum(dO * O)
    from O rounded to bf16, as the flash backward does from the output
    its forward returned: from an f32 O, delta parts from it by the
    rounding of O, which the early rows' dQ and dK (few keys, dP - delta
    nearly cancelling) magnify past the tolerance.  Returns each
    output's excess."""

    import torch

    g = torch.Generator("cuda").manual_seed(9)
    q, k, v, do = (torch.randn((BH // HEADS, 255, HEADS, D), generator=g,
                               device="cuda").to(torch.bfloat16)
                   for _ in range(4))
    qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
    out = K.flash_attention(qg, kg, vg, causal=True)
    out.backward(do)

    qr, kr, vr, dor = (t.float().transpose(1, 2) for t in (q, k, v, do))
    keep = torch.ones((255, 255), dtype=torch.bool, device="cuda").tril()
    p = (qr @ kr.mT * D ** -0.5).masked_fill(~keep, float("-inf")
                                              ).softmax(-1)
    o = (p @ vr).to(torch.bfloat16)
    delta = (dor * o.float()).sum(-1, keepdim=True)
    ds = p * (dor @ vr.mT - delta) * D ** -0.5
    pairs = {"o": (out, o), "dq": (qg.grad, ds @ kr),
             "dk": (kg.grad, ds.mT @ qr), "dv": (vg.grad, p.mT @ dor)}
    return {name: check_close(K, f"flash_attention {name} vs dense", got,
                              want.to(torch.bfloat16).transpose(1, 2))
            for name, (got, want) in pairs.items()}


def model_check(M) -> dict:
    """One bench train step with flash attention against one of the dense
    model from the same parameters and tokens: the update of each
    attention projection (q, k and v columns of ``wqkv``, and ``wo``)
    within UPDATE_RTOL (relative Frobenius error), the loss within rtol
    2e-2 (the JAX package's own check), and finite bf16 logits of the
    expected shape."""

    import dataclasses

    import torch

    tokens = torch.randint(0, 2048, (8, 256), device="cuda",
                           generator=torch.Generator("cuda").manual_seed(1))
    updates, losses = {}, {}
    for flash in (True, False):
        cfg = dataclasses.replace(M.ModelConfig.bench(), flash=flash)
        params = M.init_params(torch.Generator("cuda").manual_seed(0), cfg)
        if flash:
            with torch.no_grad():
                logits = M.forward(cfg, params, tokens)
        before = {n: params["layers"][n].clone() for n in ("wqkv", "wo")}
        params, loss = M.train_step(cfg, params, tokens)
        up = {n: params["layers"][n] - before[n] for n in before}
        wq, wk, wv = up["wqkv"].chunk(3, dim=-1)
        updates[flash] = {"wq": wq, "wk": wk, "wv": wv, "wo": up["wo"]}
        losses[flash] = loss.item()
    if logits.shape != (8, 256, 2048):
        raise AssertionError(f"logits shape {tuple(logits.shape)}")
    if not torch.isfinite(logits.float()).all():
        raise AssertionError("non-finite logits")
    if not math.isclose(losses[True], losses[False], rel_tol=2e-2):
        raise AssertionError(f"flash loss {losses[True]} vs dense "
                             f"{losses[False]}")
    rel = {n: ((updates[True][n] - b).norm() / b.norm()).item()
           for n, b in updates[False].items()}
    if not max(rel.values()) <= UPDATE_RTOL:
        raise AssertionError(f"flash train step's updates part from the "
                             f"dense model's: {rel}")
    return {"loss_flash": losses[True], "loss_dense": losses[False],
            "update_rel_err": rel}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        return fail("torch.cuda.is_available() is false")
    sys.path.insert(0, HERE)
    try:
        import tpumon_torch
        from tpumon_torch import _build, fields
        from tpumon_torch.loadgen import kernels as K
        from tpumon_torch.loadgen import model as M
        from tpumon_torch.loadgen import run as R
    except ImportError as e:
        return fail(f"tpumon_torch not found beside chip_smoke.py: {e}")
    if os.path.dirname(os.path.dirname(
            os.path.abspath(tpumon_torch.__file__))) != HERE:
        return fail(f"imported tpumon_torch from {tpumon_torch.__file__}, "
                    f"not from this checkout")

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0])

    t0 = time.monotonic()
    lib = _build.load()
    print(f"build: {time.monotonic() - t0:.1f} s")
    for line in _build.build_log().splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print("  " + line.strip()[:160])

    rows = kernel_cases(K, lib)
    print("attention check, excess: " + json.dumps(attention_check(K)))
    print("model check: " + json.dumps(model_check(M)))

    for name in K.LAUNCHES:
        K.LAUNCHES[name] = 0
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = R.main(["--size", "bench", "--self-monitor", "--seconds", "10",
                     "--json"])
    launches = dict(K.LAUNCHES)
    out = buf.getvalue().strip().splitlines()
    if rc != 0 or not out:
        return fail(f"main path exited {rc}")
    result = json.loads(out[-1])
    print("main path: " + json.dumps(result))
    F = fields.F
    hbm = {fields.CATALOG[int(F.HBM_USED)].prom_name,
           fields.CATALOG[int(F.HBM_TOTAL)].prom_name}
    loss = result.get("final_loss")
    if loss is None or not math.isfinite(loss):
        return fail(f"final loss {loss}")
    if result.get("steps", 0) <= 0:
        return fail("no training steps ran")
    if result.get("families_nonblank", 0) <= 0:
        return fail("no non-blank metric families")
    if not hbm <= set(result.get("families", [])):
        return fail(f"HBM families {sorted(hbm)} blank")
    for name, _, _ in KERNELS:
        if launches.get(name, 0) <= 0:
            return fail(f"kernel {name} never launched on the main path")
        rows[name]["launches"] = launches[name]

    print(json.dumps({"kernels": [rows[n] for n, _, _ in KERNELS]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
