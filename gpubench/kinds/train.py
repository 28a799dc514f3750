"""The ``train`` kind: the bench transformer (``model``: sizes, batch,
learning rate) as the program's CUDA-graph SGD step
(``loadgen.graph.GraphStep``), on weights and a token batch drawn from
the seed on the card in one call per leaf.

The check follows the contract's training rule: the steps compared are
the job's first ones through the window's own call, before the window,
on the object the window then steps; each step's loss, the first step's
gradient as SGD applied it (by its norm and by its distance) and the
parameters' change over the steps, against the reference's SGD from the
same weights and batch.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from .. import flops
from ..reference import model as RM
from . import gen

FAULTS = ("unchanged", "half_batch", "altered", "silent")


def train_inputs(model: Dict, seed: int, device) -> Tuple[Dict, torch.Tensor]:
    """The weights (float32, the program's layout) and token batch of a
    seed, drawn on ``device``."""

    L, D, F, V = (model["n_layers"], model["d_model"], model["d_ff"],
                  model["vocab"])
    g = gen(seed, 0, device)

    def norm(shape, fan_in):
        return torch.randn(shape, generator=g, device=device) * fan_in ** -0.5

    params = {
        "embed": norm((V, D), D),
        "layers": {"wqkv": norm((L, D, 3 * D), D), "wo": norm((L, D, D), D),
                   "w1": norm((L, D, F), D), "w2": norm((L, F, D), F),
                   "ln1": torch.ones((L, D), device=device),
                   "ln2": torch.ones((L, D), device=device)},
        "ln_f": torch.ones((D,), device=device),
        "unembed": norm((D, V), D),
    }
    tokens = torch.randint(0, V, (model["batch"], model["seq_len"]),
                           generator=gen(seed, 1, device), device=device)
    return params, tokens


def build(job, w: Dict, seed: int, device) -> None:
    from tpumon_torch.loadgen import model as M
    from tpumon_torch.loadgen.graph import GraphStep

    model = w["model"]
    cfg = M.ModelConfig(vocab=model["vocab"], d_model=model["d_model"],
                        n_heads=model["n_heads"],
                        n_layers=model["n_layers"], d_ff=model["d_ff"],
                        seq_len=model["seq_len"], flash=model["flash"])
    params, tokens = train_inputs(model, seed, device)
    job.inputs = (M.tree_map(lambda t: t.detach().cpu().clone(), params),
                  tokens.cpu().clone())
    if job.fault == "half_batch":
        tokens = tokens[: tokens.shape[0] // 2].contiguous()
    job.pattern = "train"
    job.graph = GraphStep(cfg, params, tokens, lr=model["lr"])
    job._train = job.graph.step
    job.shapes = {"b": model["batch"], "s": model["seq_len"] - 1,
                  "h": model["n_heads"],
                  "d": model["d_model"] // model["n_heads"]}


def draws(check: Dict, seconds: float, rng) -> List[int]:
    return []


def setup(job, check: Dict) -> None:
    """The job's first ``check["setup_steps"]`` steps, through the
    window's own call, before the window: the losses, and the parameters
    before the first and after each (on the host)."""

    from tpumon_torch.loadgen import model as M

    def snap():
        return M.tree_map(lambda t: t.detach().cpu().clone(),
                          job.graph.params)

    #: steps the program ran before these (its graph's warm-up)
    job.steps_before = job.graph.steps
    job.setup_params.append(snap())
    for _ in range(check["setup_steps"]):
        job.step()
        job.sync()
        job.setup_losses.append(job.graph.loss.item())
        job.setup_params.append(snap())


def hold(job) -> None:
    """The step left undone: the parameters stay, the last loss is read
    again."""

    job.loss = job.graph.loss


def _leaves(params: Dict) -> Dict[str, torch.Tensor]:
    out = {"embed": params["embed"], "ln_f": params["ln_f"],
           "unembed": params["unembed"]}
    out.update(params["layers"])
    return {k: out[k].double() for k in RM.LEAVES}


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


def _nest(flat: Dict[str, torch.Tensor]) -> Dict:
    layers = ("wqkv", "wo", "w1", "w2", "ln1", "ln2")
    return {"embed": flat["embed"], "ln_f": flat["ln_f"],
            "unembed": flat["unembed"],
            "layers": {k: flat[k] for k in layers}}


def train_numbers(model: Dict, lr: float, params0: Dict,
                  tokens: torch.Tensor, before: int, losses: List[float],
                  snaps: List[Dict], device, fp8: bool = False
                  ) -> Dict[str, float]:
    """The train comparison: the program's ``losses`` and parameter
    ``snaps`` (before its first compared step and after each) of steps
    ``before + 1 ..``, against the reference's SGD from ``params0``.  With
    ``fp8`` the reference's own fp8 run stands where the program's
    numbers do (the control)."""

    n = len(losses)
    p0 = {k: v.to(device) for k, v in RM.flat(_to(params0, device)).items()}
    tok = tokens.to(device)
    with RM.fp32():
        r_loss, r_grads, r_states = RM.train(model, _nest(p0), tok,
                                             before + n, lr)
        if fp8:
            c_loss, c_grads, c_states = RM.train(model, _nest(p0), tok,
                                                 before + n, lr, fp8=True)
            losses = c_loss[before:]
            snaps = [c_states[before + i] for i in range(n + 1)]
        else:
            snaps = [_leaves(_to(s, device)) for s in snaps]
    keep = RM.moving_leaves(r_grads[before])
    grad = {k: (snaps[0][k].double() - snaps[1][k].double()) / lr
            for k in keep}
    delta = {k: snaps[n][k].double() - snaps[0][k].double() for k in keep}
    r_delta = {k: r_states[before + n][k].double()
               - r_states[before][k].double() for k in keep}
    return {
        "loss_gap": max(abs(a - b) / abs(b)
                        for a, b in zip(losses, r_loss[before:])),
        "grad_norm_gap": RM.norm_gap(grad, r_grads[before], keep),
        "grad_rel_err": RM.diff_gap(grad, r_grads[before], keep),
        "change_norm_gap": RM.norm_gap(delta, r_delta, keep),
    }


def numbers(job, w: Dict, check: Dict, device) -> Dict:
    params0, tokens = job.inputs
    return train_numbers(w["model"], w["model"]["lr"], params0, tokens,
                         job.steps_before, job.setup_losses,
                         job.setup_params, device)


def control(run) -> Dict:
    """The reference's own fp8 run from the seed's weights and batch in
    the program's place."""

    w = run.traffic["workload"]
    params0, tokens = run.job.inputs
    n = run.traffic["check"]["setup_steps"]
    return train_numbers(w["model"], w["model"]["lr"], params0, tokens,
                         run.job.steps_before, [0.0] * n, [None] * (n + 1),
                         run.device, fp8=True)


def flash_attention_call(shapes: Dict[str, int]) -> Dict:
    """One layer's attention call of a step, forward and backward."""

    return dict(shapes, backward=True)


def step_flops(w: Dict, shapes: Dict[str, int]) -> int:
    return flops.train_step_flops(w["model"])
