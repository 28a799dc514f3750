"""The bench train step as one CUDA graph.

Counterpart of ``jax.jit(functools.partial(M.train_step, cfg))``
(``tpumon/loadgen/run.py:139``): the reference compiles its step into one
XLA program, which the device paces; the eager :func:`..model.train_step`
issues some 300 kernels from Python, and the host paces it.
:class:`GraphStep` captures the step once -- the loss,
``torch.autograd.grad`` and the in-place SGD update -- into a
``torch.cuda.CUDAGraph`` over static buffers (the token batch, the
parameter leaves and a 0-dim loss), then replays it.

* Set-up: the kernels are built and loaded (:func:`.._build.load`) and
  :data:`WARMUP_STEPS` steps run on a side stream before the capture, as
  PyTorch's whole-network capture asks: no ``nvcc``, no ``dlopen`` and no
  host synchronization happen inside it.  The warm-up steps are real SGD
  steps (:attr:`GraphStep.steps` counts them).
* Launch counts: the kernel wrappers count at capture time, when nothing
  launches.  The capture's counts are taken back out of
  :data:`..kernels.LAUNCHES` and added again on every replay.
* The trace engine: a replay runs no aten op, so its kernels come with no
  op and no FLOPs.  :meth:`GraphStep.describe` records what the graph
  runs (:func:`tpumon_torch.trace.record_graph_program`) for the engine to
  read replays by.
* Only a CUDA device: on the CPU the runner steps eagerly; a capture or a
  replay that fails raises, with no fallback to eager on the card.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import kernels as K
from . import model as M

#: side-stream steps before the capture (the caching allocator, cuBLAS's
#: workspaces and the kernels' one-time attributes settle there)
WARMUP_STEPS = 3


class GraphStep:
    """One SGD step of ``cfg``'s model on ``params`` (updated in place)
    over the fixed batch ``tokens``, captured as a CUDA graph.  Call
    :meth:`step` as the runner calls :func:`..model.train_step`."""

    def __init__(self, cfg: M.ModelConfig, params: M.Params,
                 tokens: torch.Tensor, lr: float = 1e-3) -> None:
        device = tokens.device
        if device.type != "cuda":
            raise ValueError(f"GraphStep needs a CUDA device, got {device} "
                             f"(the CPU steps eagerly: model.train_step)")
        self.cfg, self.params, self.tokens, self.lr = cfg, params, tokens, lr
        self.leaves = [t for t in M.tree_leaves(params)
                       if t.is_floating_point()]
        for t in self.leaves:
            t.requires_grad_(True)
        self.loss = torch.zeros((), dtype=torch.float32, device=device)
        if cfg.flash:
            from .. import _build

            _build.load()
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            for _ in range(WARMUP_STEPS):
                self._body(self.params, self.leaves, self.loss)
        torch.cuda.current_stream(device).wait_stream(side)
        self.steps = WARMUP_STEPS
        before = dict(K.LAUNCHES)
        self.graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(self.graph):
                self._body(self.params, self.leaves, self.loss)
        finally:
            #: kernel launches of one replay, by wrapper
            self.launches = {k: n - before[k] for k, n in K.LAUNCHES.items()
                             if n != before[k]}
            K.LAUNCHES.update(before)
        self.program = None

    def _body(self, params: M.Params, leaves, loss_out: torch.Tensor
              ) -> None:
        """The captured work: :func:`..model.train_step`'s loss, gradients
        and update, and the loss copied into ``loss_out``."""

        loss = M.loss_fn(self.cfg, params, self.tokens)
        grads = torch.autograd.grad(loss, leaves)
        with torch.no_grad():
            for t, g in zip(leaves, grads):
                t.copy_(t.float() - self.lr * g.float())
            loss_out.copy_(loss.detach())

    def step(self) -> Tuple[M.Params, torch.Tensor]:
        """Replay the graph once: (the parameters, the step's loss), both
        the static buffers, updated in place."""

        self.graph.replay()
        for name, n in self.launches.items():
            K.LAUNCHES[name] += n
        self.steps += 1
        return self.params, self.loss

    def describe(self):
        """Record what one replay runs for the trace engine, once: one
        step of the same body, eagerly on copies of the parameters, and
        one replay, in one profiler session (the replay's SGD step is a
        real step).  Returns the :class:`tpumon_torch.trace.GraphProgram`."""

        if self.program is None:
            from ..trace import record_graph_program

            params = M.tree_map(lambda t: t.detach().clone(), self.params)
            leaves = [t for t in M.tree_leaves(params)
                      if t.is_floating_point()]
            for t in leaves:
                t.requires_grad_(True)
            scratch = torch.zeros_like(self.loss)
            self.program = record_graph_program(
                lambda: self._body(params, leaves, scratch), self.step)
        return self.program
