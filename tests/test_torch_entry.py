"""The port's harness entry points (``tpumon_torch.entry``) against the
JAX package's (``__graft_entry__.py``).

* ``entry(device="cpu")``: the forward it returns, on the reference's
  parameters (a JAX init, ``params_from_jax``) and tokens, gives the
  reference's logits within ``test_torch_model.py``'s bf16 bar (atol
  6.25e-2, 1e-2 on the mean); without a card, ``entry()`` raises.
* ``dryrun_multichip(n, device="cpu")`` passes at every n the reference
  runs (and 1); ``device="cuda"`` with more ranks than cards raises
  before a rank starts.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import __graft_entry__ as G  # noqa: E402
from tpumon_torch import entry as E  # noqa: E402
from tpumon_torch.loadgen import model as TM  # noqa: E402


def test_entry_matches_the_reference_forward():
    fn_j, (params_j, tokens_j) = G.entry()
    fn, (params, tokens) = E.entry(device="cpu")
    assert tuple(tokens.shape) == tuple(tokens_j.shape) == (4, 32)
    for path, leaf in jax.tree_util.tree_leaves_with_path(params_j):
        t = params
        for key in path:
            t = t[key.key]
        assert tuple(t.shape) == leaf.shape and t.device.type == "cpu"
    want = np.asarray(jax.jit(fn_j)(params_j, tokens_j), np.float32)
    got = fn(TM.params_from_jax(jax.tree_util.tree_map(np.asarray, params_j),
                                device="cpu"),
             torch.from_numpy(np.array(tokens_j)))
    assert tuple(got.shape) == want.shape == (4, 32, 128)
    diff = np.abs(got.float().numpy() - want)
    assert diff.max() <= 6.25e-2 and diff.mean() <= 1e-2
    # its own arguments run too
    assert torch.isfinite(fn(params, tokens).float()).all()


def test_entry_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        E.entry()


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_dryrun_multichip_on_cpu_ranks(n):
    E.dryrun_multichip(n, device="cpu")


def test_dryrun_multichip_refuses_more_ranks_than_cards():
    with pytest.raises(RuntimeError):
        E.dryrun_multichip(2, device="cuda")
