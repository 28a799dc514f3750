"""The ``mxu`` kind: ``tiles`` x (tile, tile) bf16 states through the
program's tile-product kernel (``loadgen.kernels.mxu_burn``), ``iters``
products a step, each step's output the next input, with w a Hadamard
matrix over sqrt(tile) with signed columns (``chain_weight``: orthogonal
and exact in bf16, so the chain stays bounded where a random w
overflows)."""

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


def hadamard(n: int, device) -> torch.Tensor:
    """The Sylvester-Hadamard matrix of order ``n`` (a power of 2) over
    sqrt(n): orthogonal, every entry +-1/sqrt(n)."""

    h = torch.ones((1, 1), device=device)
    while h.shape[0] < n:
        h = torch.cat([torch.cat([h, h], 1), torch.cat([h, -h], 1)], 0)
    return h / n ** 0.5


def chain_weight(n: int, device) -> torch.Tensor:
    """The mix's w: the Hadamard matrix with its columns' signs drawn once
    (generator seed 0).  Orthogonal and exact in bf16 like it, but no
    power up to 64 is near the identity (the plain Sylvester matrix is
    its own inverse, so an even chain would equal a step skipped)."""

    signs = torch.randint(0, 2, (n,), generator=torch.Generator()
                          .manual_seed(0)).float() * 2 - 1
    return hadamard(n, "cpu").mul(signs).to(device)


def build(job, w: Dict, seed: int, device) -> None:
    from tpumon_torch.loadgen import kernels as K

    tiles = w["tiles"] or K.mxu_tiles(device)
    tile, iters = w["tile"], w["iters"]
    x = torch.randn((tiles, tile, tile), generator=gen(seed, 0, device),
                    device=device).to(torch.bfloat16)
    wt = chain_weight(tile, device).to(torch.bfloat16)
    job.pattern = "mxu"
    job._step = lambda s: K.mxu_burn(s, wt, iters=iters)
    job.state = x
    job.weights = wt
    job.shapes = {"tiles": tiles, "tile": tile, "iters": iters}


def hold(job) -> None:
    """The step left undone: the state stays as it was."""


def error(job, before, after, fp8: bool = False) -> float:
    """One drawn step's output against the float32 chain from its input,
    rounded to bf16 after each product (``fp8``: the control's output
    stands for the program's)."""

    iters = job.shapes["iters"]
    with RM.fp32():
        want = RK.mxu_chain(before, job.weights, iters)
        got = RK.mxu_chain(before, job.weights, iters, fp8=True) if fp8 \
            else after
    return RK.max_rms_error(got, want)


def numbers(job, w: Dict, check: Dict, device) -> Dict:
    return pattern_numbers(job, error)


def control(run) -> Dict:
    return pattern_control(run, error)


def mxu_burn_call(shapes: Dict[str, int]):
    """(tiles, tile, iters) of the one tile-product call a step makes."""

    return shapes["tiles"], shapes["tile"], shapes["iters"]


def step_flops(w: Dict, shapes: Dict[str, int]) -> int:
    return flops.mxu_burn_flops(*mxu_burn_call(shapes))
