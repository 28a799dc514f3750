"""The port's flash attention (plain CPU path of ``tpumon_torch.loadgen.
kernels``) against the JAX package's Pallas kernels in interpret mode, on
identical numpy inputs — ``test_loadgen.py::test_flash_attention_matches_
dense`` case by case, plus gradients.

Tolerances: outputs at rtol/atol 2e-5 in f32, as the reference holds its
kernel to the dense oracle.  dQ, dK and dV against ``jax.vjp`` of the same
call at 1e-4: each gradient element sums S products of recomputed tiles
whose f32 rounding differs between the two frameworks' matmul orders.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from tpumon.loadgen import kernels as JK  # noqa: E402
from tpumon_torch import _build  # noqa: E402
from tpumon_torch.loadgen import kernels as TK  # noqa: E402


@pytest.fixture(autouse=True)
def _two_torch_threads():
    """The plain flash versions loop over tiles on every core torch is
    given; two threads keep them from crowding the suite's other
    workers."""

    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


B, S, H, D = 2, 64, 2, 8

# (causal, block_q, block_k, seq): causal and non-causal, uneven blocks
# across the streaming loop, non-divisible S with causal tail padding
CASES = [
    pytest.param(True, 16, 16, 64, id="causal"),
    pytest.param(False, 16, 16, 64, id="noncausal"),
    pytest.param(True, 32, 8, 64, id="uneven-32-8"),
    pytest.param(True, 16, 16, 60, id="causal-pad-60"),
    # odd blocks put a tile's only live entry on the skip rule's boundary
    # ((i+1)*bq-1 == j*bk at i=0, j=1)
    pytest.param(True, 5, 4, 20, id="boundary-5-4"),
]


def _inputs(seq, seed=4):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, S, H, D)).astype(np.float32)[:, :seq]
            for _ in range(4)]


def _jax_flash(causal, bq, bk):
    def fn(q, k, v):
        return JK.flash_attention(q, k, v, causal=causal, block_q=bq,
                                  block_k=bk, interpret=True)
    return fn


@pytest.mark.parametrize("causal,bq,bk,seq", CASES)
def test_flash_matches_pallas_forward_and_vjp(causal, bq, bk, seq):
    q, k, v, g = _inputs(seq)
    want, vjp = jax.vjp(_jax_flash(causal, bq, bk), q, k, v)
    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    got = TK.flash_attention(tq, tk, tv, causal=causal, block_q=bq,
                             block_k=bk)
    assert got.shape == q.shape
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=2e-5, atol=2e-5)
    got.backward(torch.from_numpy(g))
    for t, w in zip((tq, tk, tv), vjp(g)):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w),
                                   rtol=1e-4, atol=1e-4)


def test_noncausal_indivisible_refuses_like_reference():
    q, k, v, _ = _inputs(60)
    with pytest.raises(ValueError):
        _jax_flash(False, 16, 16)(q, k, v)
    with pytest.raises(ValueError):
        TK.flash_attention(*map(torch.from_numpy, (q, k, v)), causal=False,
                           block_q=16, block_k=16)


@pytest.mark.parametrize("causal", [True, False])
def test_attention_combine_matches_reference(causal):
    """The online-softmax step itself, fully-masked rows included (the
    first tile of a causal row block past the diagonal)."""

    rng = np.random.default_rng(0)
    q, k, v = (rng.standard_normal((3, 8, 4)).astype(np.float32)
               for _ in range(3))
    m = np.full((3, 8, 1), -np.inf, np.float32)
    m[0] = 0.5
    l = np.abs(rng.standard_normal((3, 8, 1))).astype(np.float32)
    acc = rng.standard_normal((3, 8, 4)).astype(np.float32)
    mask = (np.tril(np.ones((8, 8), bool), -2) if causal else None)
    want = JK.attention_combine(q, k, v, m, l, acc, scale=0.5, mask=mask)
    got = TK.attention_combine(
        *map(torch.from_numpy, (q, k, v, m, l, acc)), scale=0.5,
        mask=None if mask is None else torch.from_numpy(mask))
    for g_, w in zip(got, want):
        np.testing.assert_allclose(g_.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-6)


def test_cpu_wrappers_run_plain_versions_and_count_nothing():
    """On CPU tensors the wrappers take the plain versions; the launch
    counts move only when a kernel launches."""

    before = dict(TK.LAUNCHES)
    q, k, v, g = (torch.from_numpy(x) for x in _inputs(64))
    qf, kf, vf, do = (x.transpose(1, 2).reshape(B * H, S, D).contiguous()
                      for x in (q, k, v, g))
    o, lse = TK.flash_fwd(qf, kf, vf, True, 16, 16)
    o_p, lse_p = TK.flash_fwd_plain(qf, kf, vf, True, 16, 16)
    assert torch.equal(o, o_p) and torch.equal(lse, lse_p)
    delta = (do * o).sum(-1)
    assert torch.equal(TK.flash_bwd_dq(qf, kf, vf, do, lse, delta, True, 16,
                                       16),
                       TK.flash_bwd_dq_plain(qf, kf, vf, do, lse, delta,
                                             True, 16, 16))
    assert TK.LAUNCHES == before


def test_mixed_devices_refused():
    t = torch.zeros((1, 8, 64))
    meta = torch.zeros((1, 8, 64), device="meta")
    with pytest.raises(ValueError):
        TK.flash_fwd(t, t, meta, True, 8, 8)


@pytest.mark.parametrize("edited", ["flash_attn.cu", "mma.cuh"])
def test_library_name_covers_source_and_headers(tmp_path, edited):
    """An edit to a source or to a header it includes names a new
    library: a stale build is never loaded."""

    for name in ("flash_attn.cu", "mma.cuh"):
        (tmp_path / name).write_bytes(
            (_build.PKG_DIR / "csrc" / name).read_bytes())
    src = tmp_path / "flash_attn.cu"
    before = _build.source_digest(src)
    assert _build.source_digest(src) == before
    with open(tmp_path / edited, "a") as f:
        f.write("\n// edited\n")
    assert _build.source_digest(src) != before


def test_failed_build_raises(monkeypatch, tmp_path):
    """No nvcc: building the kernels raises; nothing falls back."""

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build.os, "access", lambda *a: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()
