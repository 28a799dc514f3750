"""The monitored job of a traffic mix: the program's ``Workload``, built
from the run's seed, that ``tpumon_torch.loadgen.run.run_window`` steps.

What the job runs is its mix's ``workload.kind``, a module of
``gpubench/kinds/`` found by name (``kinds.load``): it builds the
program's step on the seed's inputs and knows how that step is checked
and counted.  Besides stepping, the job records what the comparison and
the readers need: the sync points, the states around the steps drawn for
the check, and, when asked, one profiler stretch of its own thread.
"""

from __future__ import annotations

import random
import time
from typing import Dict, List, Optional, Tuple

import torch

from tpumon_torch.loadgen.run import Workload

from . import kinds


def _clone(state):
    if isinstance(state, torch.Tensor):
        return state.detach().clone()
    return tuple(_clone(s) for s in state)


class Stretch:
    """One profiler stretch of the job's own thread, ``start_s`` after the
    window opens and ``length_s`` long, opened under the program's
    profiler lock and only while no capture of its trace engine holds
    it."""

    def __init__(self, start_s: float, length_s: float) -> None:
        self.start_s, self.length_s = start_s, length_s
        self.open_at: Optional[float] = None
        self.prof = None
        self._cm = None
        self.t_open = 0.0
        self.events = None

    def arm(self, window_start: float) -> None:
        self.open_at = window_start + self.start_s

    def before_step(self) -> None:
        if self.open_at is None or self.prof is not None or \
                self.events is not None or time.monotonic() < self.open_at:
            return
        from tpumon_torch import trace

        if trace.PROFILER_LOCK.locked():
            return
        from torch.profiler import ProfilerActivity, profile

        self._cm = trace.profiler_session(timeout_s=1.0)
        self._cm.__enter__()
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.start()
        self.t_open = time.monotonic()

    def after_step(self) -> None:
        if self.prof is None or time.monotonic() < self.t_open + self.length_s:
            return
        from tpumon_torch import trace

        torch.cuda.synchronize()
        try:
            self.events = trace.close_session(self.prof).events()
        finally:
            self.prof = None
            self._cm.__exit__(None, None, None)


class Job(Workload):
    """The program's ``Workload`` on the seed's inputs (its own
    constructor draws fixed ones), recording for the check and the
    readers."""

    def __init__(self, traffic: Dict, seconds: float, seed: int, device,
                 fault: Optional[str] = None,
                 stretch: Optional[Stretch] = None) -> None:
        w = traffic["workload"]
        self.kind = w["kind"]
        self.impl = kinds.load(self.kind)
        if fault is not None and fault not in self.impl.FAULTS:
            raise ValueError(f"unknown fault {fault!r} for a {self.kind!r} "
                             f"job (one of {self.impl.FAULTS})")
        self.device = device
        self.loss = None
        self.graph = None
        self.slices = 1
        self.fault = fault
        self.stretch = stretch
        self.calls = 0
        self.syncs: List[Tuple[float, int]] = []
        #: (call index, state before, state after) of the steps drawn
        self.samples: List[Tuple[int, object, object]] = []
        #: losses and parameter snapshots of the set-up steps (train)
        self.setup_losses: List[float] = []
        self.setup_params: List[Dict] = []
        self.inputs = None
        self.weights = None
        self.steps_before = 0
        self.shapes: Dict[str, int] = {}
        self.impl.build(self, w, seed, device)
        self._draw = self.impl.draws(traffic["check"], seconds,
                                     random.Random(seed))

    def setup(self, check: Dict) -> None:
        """The steps the kind's check needs before the window."""

        setup = getattr(self.impl, "setup", None)
        if setup is not None:
            setup(self, check)

    # -- the timed path ------------------------------------------------------

    def step(self) -> None:
        self.calls += 1
        if self.stretch is not None:
            self.stretch.before_step()
        drawn = bool(self._draw) and self.calls == self._draw[0]
        if drawn:
            before = _clone(self.state)
        if self.fault == "unchanged":
            self.impl.hold(self)
        else:
            super().step()
        if self.fault == "altered" and hasattr(self.impl, "alter"):
            self.impl.alter(self)
        if drawn:
            self._draw.pop(0)
            self.samples.append((self.calls, before, _clone(self.state)))
        if self.stretch is not None:
            self.stretch.after_step()

    def sync(self) -> None:
        super().sync()
        self.syncs.append((time.monotonic(), self.calls))

    def free(self) -> None:
        """Drop the program's device state (the graph and the weights it
        trains, the pattern's state) before the reference runs; what was
        recorded for the check stays."""

        self.graph = self._train = self._step = None
        self.state = self.loss = None
