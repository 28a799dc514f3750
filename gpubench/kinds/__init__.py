"""The kinds of monitored job a traffic mix names (``workload.kind``), one
module a kind, ``kinds/<kind>.py``, found by name as the metric readers
are.  A later mix of a new kind adds its module and its mix file and
edits nothing that is there.

A kind module gives:

* ``FAULTS``: the faults a test can plant in a run of it;
* ``build(job, workload, seed, device)``: the program's step on the
  seed's inputs, set on the job (``job.pattern``, then ``job._train`` or
  ``job._step`` and ``job.state``), with ``job.shapes``;
* ``draws(check, seconds, rng)``: the calls whose states the check keeps;
* ``setup(job, check)``, optional: steps the check needs before the
  window, through the window's own call;
* ``hold(job)``: the step left undone (the ``unchanged`` fault);
  ``alter(job)``, optional: the step's answer altered where it is made;
* ``numbers(job, workload, check, device)``: the numbers compared, of
  what the timed path produced;
* ``control(run)``: the same numbers with the reference computed in the
  precision below the stated one in the program's place;
* ``step_flops(workload, shapes)``: the operations of one step;
* optional ``flash_attention_call(shapes)`` and ``mxu_burn_call(shapes)``:
  the kernel calls one step makes, for the rooflines' readers.

The helpers below serve the load patterns: a step whose state is its
answer, each drawn step compared with the reference from its input.
"""

from __future__ import annotations

import importlib
import random
from typing import Callable, Dict, List

import torch


def load(kind: str):
    """The module of a workload kind."""

    return importlib.import_module(f"gpubench.kinds.{kind}")


def gen(seed: int, stream: int, device) -> torch.Generator:
    """A generator on ``device`` for one stream of a seed's draws."""

    return torch.Generator(device).manual_seed(
        (seed * 1000003 + stream) % (1 << 63))


def draw_steps(check: Dict, seconds: float, rng: random.Random) -> List[int]:
    """``check["samples"]`` call indices drawn from the calls the window
    makes at ``check["steps_lower_per_s"]`` or more."""

    lower = max(2, int(check["steps_lower_per_s"] * seconds))
    return sorted(rng.sample(range(1, lower),
                             min(check["samples"], lower - 1)))


def alter_output(job) -> None:
    """Change one element of the step's answer (the ``altered`` fault)."""

    out = job.state if isinstance(job.state, torch.Tensor) else job.state[0]
    first = (0,) * out.dim()
    out[first] += 1.0 + out[first].abs()


def pattern_numbers(job, error: Callable) -> Dict:
    """The worst drawn step's ``error(job, before, after)``."""

    errs = [error(job, before, after) for _, before, after in job.samples]
    return {"step_err_rms": max(errs) if errs else None,
            "steps_compared": float(len(errs))}


def pattern_control(run, error: Callable) -> Dict:
    """The control of a pattern: the reference in float8 from the seed's
    first input, in the program's place."""

    from ..workloads import Job

    job = Job(run.traffic, run.seconds, run.seed, run.device)
    try:
        return {"step_err_rms": error(job, job.state, None, fp8=True)}
    finally:
        job.free()
