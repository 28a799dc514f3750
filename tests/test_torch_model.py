"""The port's transformer (``tpumon_torch.loadgen.model``) against the JAX
package's (``tpumon.loadgen.model``) on the same parameters — a JAX init
loaded through ``params_from_jax`` — and the same tokens, on the CPU.

Tolerances, each with its reason:

* loss: rtol 2e-2, the reference's own flash-vs-dense bar
  (``test_loadgen.py:62-64``);
* logits: they are bf16, and the frameworks round bf16 intermediates at
  different places (XLA keeps fused elementwise chains in f32), so they
  agree to two bf16 ulps at their magnitude (|logits| < 8): atol 6.25e-2,
  and 1e-2 on the mean;
* one SGD step: at lr 1e-3 the step moves a weight by at most ~1e-4, and
  the bf16 gradients agree to a few percent of that, so the updated f32
  weights match to 5e-6 absolute.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from tpumon.loadgen import model as JM  # noqa: E402
from tpumon_torch.loadgen import model as TM  # noqa: E402


@pytest.fixture(autouse=True)
def _two_torch_threads():
    """The model's forward and train steps run on every core torch is
    given; two threads keep them from crowding the suite's other
    workers."""

    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


ATTN = [pytest.param(False, id="dense"), pytest.param(True, id="flash")]


def _configs(flash):
    return (dataclasses.replace(JM.ModelConfig.tiny(), flash=flash),
            dataclasses.replace(TM.ModelConfig.tiny(), flash=flash))


def _setup(flash, batch=4):
    cfg_j, cfg_t = _configs(flash)
    pj = JM.init_params(jax.random.PRNGKey(0), cfg_j)
    np_params = jax.tree_util.tree_map(np.asarray, pj)
    pt = TM.params_from_jax(np_params, device="cpu")
    tokens = np.random.default_rng(1).integers(
        0, cfg_j.vocab, (batch, cfg_j.seq_len)).astype(np.int32)
    return cfg_j, cfg_t, pj, np_params, pt, tokens


def _leaf(tree, path):
    for key in path:
        tree = tree[key.key]
    return tree


def test_configs_match():
    for name in ("tiny", "bench"):
        assert (dataclasses.asdict(getattr(JM.ModelConfig, name)()) ==
                dataclasses.asdict(getattr(TM.ModelConfig, name)()))


def test_init_params_structure_matches():
    cfg_j, cfg_t = _configs(False)
    pj = JM.init_params(jax.random.PRNGKey(0), cfg_j)
    pt = TM.init_params(torch.Generator().manual_seed(0), cfg_t)
    for path, leaf in jax.tree_util.tree_leaves_with_path(pj):
        t = _leaf(pt, path)
        assert tuple(t.shape) == leaf.shape and t.dtype == torch.float32
    again = TM.init_params(torch.Generator().manual_seed(0), cfg_t)
    assert torch.equal(pt["embed"], again["embed"])


@pytest.mark.parametrize("flash", ATTN)
def test_forward_and_loss_match_jax(flash):
    cfg_j, cfg_t, pj, _, pt, tokens = _setup(flash)
    want = np.asarray(JM.forward(cfg_j, pj, jnp.asarray(tokens)), np.float32)
    got = TM.forward(cfg_t, pt, torch.from_numpy(tokens))
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape
    diff = np.abs(got.float().numpy() - want)
    assert np.abs(want).max() < 8.0
    assert diff.max() <= 6.25e-2 and diff.mean() <= 1e-2
    l_j = float(JM.loss_fn(cfg_j, pj, jnp.asarray(tokens)))
    l_t = TM.loss_fn(cfg_t, pt, torch.from_numpy(tokens)).item()
    np.testing.assert_allclose(l_t, l_j, rtol=2e-2)


@pytest.mark.parametrize("flash", ATTN)
def test_layer_matches_jax_in_f32(flash):
    """One layer in f32, where neither side rounds to bf16: the norms
    (small inputs, so the 1e-6 epsilon counts), the tanh GELU and both
    attention paths agree to f32 summation order (1e-5)."""

    cfg_j, cfg_t = _configs(flash)
    pj = JM.init_params(jax.random.PRNGKey(0), cfg_j)
    layer = {k: np.array(v[0]) for k, v in pj["layers"].items()}
    x = (0.05 * np.random.default_rng(2).standard_normal(
        (2, cfg_j.seq_len, cfg_j.d_model))).astype(np.float32)
    want = np.asarray(JM._layer(cfg_j, jnp.asarray(x),
                                {k: jnp.asarray(v) for k, v in layer.items()}))
    got = TM._layer(cfg_t, torch.from_numpy(x),
                    {k: torch.from_numpy(v) for k, v in layer.items()})
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_sgd_update_is_exact():
    """train_step applies p - lr*g in f32 to every parameter, exactly."""

    _, cfg_t, _, _, pt, tokens = _setup(False)
    tokens = torch.from_numpy(tokens)
    old = TM.tree_map(lambda t: t.clone(), pt)
    leaves = TM.tree_leaves(pt)
    for t in leaves:
        t.requires_grad_(True)
    grads = torch.autograd.grad(TM.loss_fn(cfg_t, pt, tokens), leaves)
    new, _ = TM.train_step(cfg_t, pt, tokens, lr=1e-3)
    for t, o, g in zip(TM.tree_leaves(new), TM.tree_leaves(old), grads):
        torch.testing.assert_close(t.detach(), o - 1e-3 * g, rtol=0,
                                   atol=1e-9)


@pytest.mark.parametrize("flash", ATTN)
def test_one_sgd_step_matches_jax(flash):
    cfg_j, cfg_t, pj, np_params, pt, tokens = _setup(flash)
    new_j, loss_j = jax.jit(functools.partial(JM.train_step, cfg_j))(
        pj, jnp.asarray(tokens))
    new_t, loss_t = TM.train_step(cfg_t, pt, torch.from_numpy(tokens))
    np.testing.assert_allclose(loss_t.item(), float(loss_j), rtol=2e-2)
    moved = 0
    for path, leaf in jax.tree_util.tree_leaves_with_path(new_j):
        got = _leaf(new_t, path).detach().numpy()
        np.testing.assert_allclose(got, np.asarray(leaf), rtol=0, atol=5e-6)
        moved += int(np.any(got != _leaf(np_params, path)))
    assert moved == len(jax.tree_util.tree_leaves(new_j))


@pytest.mark.parametrize("flash", ATTN)
def test_five_steps_reduce_loss(flash):
    _, cfg_t, _, _, pt, tokens = _setup(flash, batch=8)
    tokens = torch.from_numpy(tokens)
    pt, first = TM.train_step(cfg_t, pt, tokens)
    for _ in range(5):
        pt, loss = TM.train_step(cfg_t, pt, tokens)
    assert loss.item() < first.item()


def test_flash_model_matches_dense():
    """Flash attention is a drop-in for the dense path (the reference's
    check, on the port alone)."""

    _, cfg_t, _, _, pt, tokens = _setup(False)
    tokens = torch.from_numpy(tokens)
    dense = TM.loss_fn(cfg_t, pt, tokens).item()
    flash = TM.loss_fn(dataclasses.replace(cfg_t, flash=True), pt,
                       tokens).item()
    np.testing.assert_allclose(flash, dense, rtol=2e-2)


@pytest.mark.parametrize("name", ["tiny", "bench"])
@pytest.mark.parametrize("batch", [1, 8])
def test_dot_flops_equal(name, batch):
    assert (TM.train_step_dot_flops(getattr(TM.ModelConfig, name)(), batch)
            == JM.train_step_dot_flops(getattr(JM.ModelConfig, name)(),
                                       batch))
