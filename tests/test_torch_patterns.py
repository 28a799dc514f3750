"""The port's load-shaping kernels and patterns (plain CPU path of
``tpumon_torch.loadgen.kernels``) against the JAX package's Pallas kernels
in interpret mode and its ``make_pattern`` steps, on identical numpy
inputs; and the runner's patterns on the CPU.

Tolerances, each with its reason:

* ``mxu_burn``: identity through identity is exact (atol 1e-2, the
  reference's own check).  Through an orthogonal w, both versions sum
  exact bf16 products in f32 in their own order and round every step to
  bf16, so their chains part by ulps that the later steps carry forward:
  held by ``kernels.mxu_excess`` (every element within 8 * sqrt(iters)
  bf16 unit roundoffs of the output's RMS).
* ``hbm_stream``: rtol 1e-6 on the reference's constant input, its own
  check.  On random input the port equals ``x * 1.0001 + 0.25`` rounded
  twice in f32 bit for bit, as its kernel does on the card; XLA on the
  CPU fuses the two into one FMA, so the reference's result may differ by
  that one rounding of the product, at most 2**-24 of |1.0001 * x|, and
  by the ulp of the result that follows from it; near a zero of the
  output that is far more than 1e-6 of it.
* the ``flash`` step: O within one bf16 ulp (rtol 2**-7, atol 1e-3): both
  sum in f32 in their own order and round O to bf16.
* the ``conv`` step: within one bf16 ulp of its unit-RMS output (rtol and
  atol 2**-7): three bf16 convolutions summed in f32 in their own order,
  each rounded to bf16, then renormalised.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from tpumon.loadgen import kernels as JK  # noqa: E402
from tpumon_torch.loadgen import kernels as TK  # noqa: E402
from tpumon_torch.loadgen import run as TR  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _two_torch_threads():
    """The patterns loop for a fixed wall time on every core torch is
    given; two keep them from crowding the suite's other workers."""

    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _jax_bf16(a):
    return jnp.asarray(a, jnp.bfloat16)


def _torch_bf16(a):
    return torch.from_numpy(np.ascontiguousarray(a)).to(torch.bfloat16)


def _np(t):
    return np.asarray(t, np.float32) if not isinstance(t, torch.Tensor) \
        else t.float().numpy()


def _orthogonal(T, seed):
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.standard_normal((T, T)))
    return q.astype(np.float32)


# ---- mxu_burn ----------------------------------------------------------------

def test_mxu_identity_through_identity():
    eye = np.eye(256, dtype=np.float32)
    want = JK.mxu_burn(_jax_bf16(eye), _jax_bf16(eye), iters=4,
                       interpret=True)
    got = TK.mxu_burn(_torch_bf16(eye), _torch_bf16(eye), iters=4)
    assert got.dtype == torch.bfloat16 and got.shape == (256, 256)
    np.testing.assert_allclose(_np(got), eye, atol=1e-2)
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-2)


@pytest.mark.parametrize("iters", [4, 64])
def test_mxu_orthogonal_chain_matches_pallas(iters):
    x = np.random.default_rng(1).standard_normal((256, 256)).astype(
        np.float32)
    w = _orthogonal(256, 2)
    want = JK.mxu_burn(_jax_bf16(x), _jax_bf16(w), iters=iters,
                       interpret=True)
    got = TK.mxu_burn(_torch_bf16(x), _torch_bf16(w), iters=iters)
    assert TK.mxu_excess(got, torch.from_numpy(_np(want)), iters) <= 1.0


def test_mxu_batch_is_independent_chains():
    """(n, T, T) x runs each tile's own chain through the one w, as the
    reference's mxu_burn does for each tile alone."""

    rng = np.random.default_rng(3)
    x = rng.standard_normal((3, 32, 32)).astype(np.float32)
    w = _orthogonal(32, 4)
    got = TK.mxu_burn(_torch_bf16(x), _torch_bf16(w), iters=5)
    for i in range(3):
        want = JK.mxu_burn(_jax_bf16(x[i]), _jax_bf16(w), iters=5,
                           interpret=True)
        assert TK.mxu_excess(got[i], torch.from_numpy(_np(want)), 5) <= 1.0


@pytest.mark.parametrize("xs,ws", [((256, 128), (256, 128)),
                                   ((64, 64), (32, 32)),
                                   ((2, 2, 32, 32), (32, 32))])
def test_mxu_refuses_what_is_not_square_tiles(xs, ws):
    x, w = torch.zeros(xs, dtype=torch.bfloat16), torch.zeros(
        ws, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        TK.mxu_burn(x, w, iters=1)
    if len(xs) == 2:
        with pytest.raises(AssertionError):
            JK.mxu_burn(jnp.zeros(xs, jnp.bfloat16),
                        jnp.zeros(ws, jnp.bfloat16), iters=1,
                        interpret=True)


# ---- hbm_stream ----------------------------------------------------------------

def test_hbm_stream_constant():
    x = np.full((512, 2048), 2.0, np.float32)
    got = TK.hbm_stream(torch.from_numpy(x))
    np.testing.assert_allclose(_np(got), 2.0 * 1.0001 + 0.25, rtol=1e-6)
    np.testing.assert_allclose(
        _np(got), _np(JK.hbm_stream(jnp.asarray(x), interpret=True)),
        rtol=1e-6)


@pytest.mark.parametrize("shape", [(512, 2048), (256, 1024), (8, 24)])
def test_hbm_stream_random_matches_pallas(shape):
    x = np.random.default_rng(5).standard_normal(shape).astype(np.float32)
    want = _np(JK.hbm_stream(jnp.asarray(x), interpret=True))
    got = TK.hbm_stream(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == shape
    twice = x * np.float32(1.0001) + np.float32(0.25)
    np.testing.assert_array_equal(_np(got), twice)
    product = np.abs(x.astype(np.float64) * np.float32(1.0001))
    assert (np.abs(_np(got) - want)
            <= 2.0 ** -24 * product + np.spacing(np.abs(want))).all()


@pytest.mark.parametrize("shape", [(300, 2048), (512, 1500)])
def test_hbm_stream_indivisible_refused_by_both(shape):
    x = np.zeros(shape, np.float32)
    with pytest.raises(AssertionError):
        JK.hbm_stream(jnp.asarray(x), interpret=True)
    with pytest.raises(ValueError, match="not divisible"):
        TK.hbm_stream(torch.from_numpy(x))


def test_hbm_stream_refuses_other_ranks():
    with pytest.raises(ValueError):
        TK.hbm_stream(torch.zeros((4, 256, 1024)))


# ---- make_pattern ----------------------------------------------------------------

@pytest.mark.parametrize("name", TK.PATTERNS)
def test_every_pattern_steps_twice(name):
    step, state = TK.make_pattern(name, device="cpu")
    state = step(step(state))
    leaves = list(TR.tensor_leaves(state))
    assert leaves and all(t.device.type == "cpu" for t in leaves)
    if name == "mixed":
        assert len(leaves) == 2 and state[2] == 2


def test_unknown_pattern_raises_like_reference():
    with pytest.raises(ValueError):
        JK.make_pattern("nope")
    with pytest.raises(ValueError):
        TK.make_pattern("nope", device="cpu")


def test_cpu_patterns_use_reference_sizes():
    """On the CPU the port runs the reference's single mxu tile, its
    (2048, 4096) f32 hbm array and its interpret sizes for flash and
    conv."""

    assert TK.mxu_tiles("cpu") == 1
    shapes = {}
    for name in TK.PATTERNS:
        _, state = TK.make_pattern(name, device="cpu")
        shapes[name] = [tuple(t.shape) for t in TR.tensor_leaves(state)]
    assert shapes["mxu"] == [(256, 256)]
    assert shapes["hbm"] == [(2048, 4096)]
    assert shapes["mixed"] == [(256, 256), (2048, 4096)]
    assert shapes["flash"] == [(1, 64, 2, 8)] * 3
    # NCHW view of NHWC memory
    assert shapes["conv"] == [(1, 8, 16, 16)]
    _, x = TK.make_pattern("conv", device="cpu")
    assert x.is_contiguous(memory_format=torch.channels_last)


def test_flash_step_matches_reference():
    rng = np.random.default_rng(6)
    q, k, v = (rng.standard_normal((1, 64, 2, 8)).astype(np.float32)
               for _ in range(3))
    jstep, _ = JK.make_pattern("flash", interpret=True)
    tstep, _ = TK.make_pattern("flash", device="cpu")
    want = jstep(tuple(_jax_bf16(a) for a in (q, k, v)))
    got = tstep(tuple(_torch_bf16(a) for a in (q, k, v)))
    np.testing.assert_allclose(_np(got[0]), _np(want[0]), rtol=2 ** -7,
                               atol=1e-3)
    # K and V ride along unchanged
    np.testing.assert_array_equal(_np(got[1]), _np(want[1]))


def test_flash_fold_hands_kernels_contiguous_heads(monkeypatch):
    """At B=1 (the flash pattern's batch) a transposed head fold can stay
    a strided view; the kernels take contiguous heads only."""

    seen = []
    real = TK.flash_fwd

    def spy(qf, kf, vf, *args):
        seen.append(all(t.is_contiguous() for t in (qf, kf, vf)))
        return real(qf, kf, vf, *args)

    monkeypatch.setattr(TK, "flash_fwd", spy)
    step, state = TK.make_pattern("flash", device="cpu")
    step(step(state))
    assert seen == [True, True]


def test_conv_step_matches_reference():
    """One conv step from the same NHWC state and the reference's own
    filters (drawn as its make_pattern draws them)."""

    C = 8
    ks = jax.random.split(jax.random.PRNGKey(0), 3)
    hwio = [jax.random.normal(kk, (3, 3, C, C), jnp.bfloat16) /
            (3.0 * C ** 0.5) for kk in ks]
    x = np.random.default_rng(7).standard_normal((1, 16, 16, C)).astype(
        np.float32)
    jstep, _ = JK.make_pattern("conv", interpret=True)
    want = _np(jstep(_jax_bf16(x)))
    ws = TK.conv_weights(_torch_bf16(_np(w)) for w in hwio)
    got = TK.conv_step(_torch_bf16(x).permute(0, 3, 1, 2), ws)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got.permute(0, 2, 3, 1)), want,
                               rtol=2 ** -7, atol=2 ** -7)


# ---- the runner ----------------------------------------------------------------

def test_tensor_leaves_skip_plain_values():
    a, b = torch.zeros(2), torch.ones(3)
    assert [t.shape for t in TR.tensor_leaves((a, (b, 7), 0))] == \
        [a.shape, b.shape]
    assert list(TR.tensor_leaves(a))[0] is a


def test_runner_cli_pattern_on_cpu():
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    r = subprocess.run(
        [sys.executable, "-m", "tpumon_torch.loadgen.run", "--seconds", "0.2",
         "--pattern", "hbm", "--device", "cpu", "--json"],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=300)
    assert r.returncode == 0, r.stderr
    d = json.loads(r.stdout.strip().splitlines()[-1])
    assert d["pattern"] == "hbm" and d["steps"] >= 1
    assert d["final_loss"] is None and d["device"] == "cpu"


@pytest.mark.parametrize("name", ["mxu", "mixed", "flash", "conv"])
def test_runner_runs_pattern_in_process(name, capsys):
    assert TR.main(["--pattern", name, "--device", "cpu", "--seconds",
                    "0.05", "--sync-every", "2", "--json"]) == 0
    d = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert d["pattern"] == name and d["steps"] >= 1
    assert set(d) >= {"steps_per_sec", "final_loss", "monitor_sweeps"}
