"""The ``flash`` kind: causal flash attention forward through the
program's public entry (``loadgen.kernels.flash_attention``) at
(b, s, h, d), bf16, each step's output the next query, k and v fixed."""

from __future__ import annotations

from typing import Dict

import torch

from .. import flops
from ..reference import kernels as RK
from ..reference import model as RM
from . import alter_output, draw_steps, gen, pattern_control, \
    pattern_numbers

FAULTS = ("unchanged", "altered", "silent")
draws = draw_steps
alter = alter_output


def build(job, w: Dict, seed: int, device) -> None:
    from tpumon_torch.loadgen import kernels as K

    b, s, h, d = w["b"], w["s"], w["h"], w["d"]
    g = gen(seed, 0, device)
    q, k, v = (torch.randn((b, s, h, d), generator=g, device=device)
               .to(torch.bfloat16) for _ in range(3))

    def step(state):
        q_cur, k_cur, v_cur = state
        with torch.no_grad():
            out = K.flash_attention(q_cur, k_cur, v_cur, causal=True)
        return (out, k_cur, v_cur)

    job.pattern = "flash"
    job._step = step
    job.state = (q, k, v)
    job.shapes = {"b": b, "s": s, "h": h, "d": d}


def hold(job) -> None:
    """The step left undone: the state stays as it was."""


def error(job, before, after, fp8: bool = False) -> float:
    """One drawn step's output against float32 causal attention of its
    input (``fp8``: the control's output stands for the program's)."""

    q, k, v = before
    with RM.fp32():
        want = RK.causal_attention(q, k, v)
        got = RK.causal_attention(q, k, v, fp8=True) if fp8 else after[0]
    return RK.max_rms_error(got, want)


def numbers(job, w: Dict, check: Dict, device) -> Dict:
    return pattern_numbers(job, error)


def control(run) -> Dict:
    return pattern_control(run, error)


def flash_attention_call(shapes: Dict[str, int]) -> Dict:
    """The one attention call a step makes: its shapes, forward only."""

    return dict(shapes, backward=False)


def step_flops(w: Dict, shapes: Dict[str, int]) -> int:
    return flops.attention_fwd_flops(shapes["b"], shapes["h"], shapes["s"],
                                     shapes["d"])
