"""The port's multi-device patterns (``tpumon_torch.loadgen.ring`` and
``parallel``) against the JAX package's, case for case with
``tests/test_ring.py``.

The JAX side runs here, on conftest's 8 virtual CPU devices; the port
runs on gloo ranks (``tests/test_torch_ranks.py``), one pool of processes
per world size for the whole module, every case in it.  Both get the same
numpy inputs and weights; each rank computes its own shard, and the shards
are put together here.  Tolerances are the reference's own: ring attention
2e-5 (f32), the pipeline 1e-4 (1e-5 at one stage), MoE 1e-4, the
all-reduce loads 1e-6 relative on their ones invariant.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
from jax.sharding import NamedSharding, PartitionSpec as P  # noqa: E402

from tpumon.loadgen import parallel as JPP  # noqa: E402
from tpumon.loadgen import ring as JR  # noqa: E402
from test_torch_ranks import RankPool  # noqa: E402

@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """world size -> its :class:`RankPool`, spawned on first use."""

    if len(jax.devices()) < 8:
        pytest.skip("needs the 8-device virtual mesh")
    d = tmp_path_factory.mktemp("ranks")
    pools = {}

    def get(world: int) -> RankPool:
        if world not in pools:
            pools[world] = RankPool(world, str(d))
        return pools[world]

    yield get
    for pool in pools.values():
        pool.close()


def _rng(seed):
    return np.random.default_rng(seed)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("n_dev", [2, 4, 8])
def test_ring_attention_matches_dense(ranks, causal, n_dev):
    B, S, H, D = 2, 16 * n_dev, 2, 8
    rng = _rng(n_dev + 10 * causal)
    q, k, v = (rng.standard_normal((B, S, H, D)).astype(np.float32)
               for _ in range(3))
    mesh = JR.make_seq_mesh(n_dev)
    sh = NamedSharding(mesh, P(None, "seq", None, None))
    want = np.asarray(JR.ring_attention(
        *(jax.device_put(x, sh) for x in (q, k, v)), mesh, causal=causal))
    got = np.concatenate(ranks(n_dev).run("ring_case", q, k, v, causal),
                         axis=1)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    dense = np.asarray(JR.ring_attention_reference(q, k, v, causal=causal))
    np.testing.assert_allclose(got, dense, rtol=2e-5, atol=2e-5)


def test_ring_attention_single_device_degenerates(ranks):
    B, S, H, D = 1, 32, 2, 8
    rng = _rng(1)
    q, k, v = (rng.standard_normal((B, S, H, D)).astype(np.float32)
               for _ in range(3))
    want = np.asarray(JR.ring_attention(q, k, v, JR.make_seq_mesh(1)))
    got = ranks(2).run("ring_case", q, k, v, True, 1)
    assert got[1] is None  # not in the 1-rank group
    np.testing.assert_allclose(got[0], want, rtol=2e-5, atol=2e-5)


def test_ring_allreduce_load_step(ranks):
    jstep, jstate = JR.ring_allreduce_load(JR.make_seq_mesh(4, axis="data"),
                                           mb_per_device=1)
    np.testing.assert_allclose(np.asarray(jstep(jstate)[:4]), 1.0,
                               rtol=1e-6)
    for first, shape, shape2 in ranks(4).run("allreduce_case", 1):
        # all-reduce of ones / n == ones: the loop can run forever
        np.testing.assert_allclose(first, 1.0, rtol=1e-6)
        # each rank holds its shard of the reference's global buffer
        assert shape == shape2 == (jstate.shape[0] // 4,)


def test_dcn_allreduce_matches_flat_psum(ranks):
    """Hierarchical reduce-scatter -> all-reduce -> all-gather over
    (slice, chip) groups == a flat mean over every rank, as the
    reference's over its (slice, chip) mesh."""

    mesh = JR.make_multislice_mesh(2, 4)
    jstep, state = JR.dcn_allreduce_load(mesh, mb_per_device=1)
    x = _rng(3).standard_normal(state.shape).astype(np.float32)
    sh = NamedSharding(mesh, P(("slice", "chip")))
    want = np.asarray(jstep(jax.device_put(x, sh))).reshape(8, -1)
    per = state.shape[0] // 8
    flat = x.reshape(8, per).sum(0) / 8
    for r, (ones, got) in enumerate(ranks(8).run("dcn_case", x, 2, 4)):
        np.testing.assert_allclose(ones, 1.0, rtol=1e-6)
        np.testing.assert_allclose(got, want[r], rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got, flat, rtol=1e-5, atol=1e-6)


def test_multislice_mesh_shapes(ranks):
    mesh = JR.make_multislice_mesh(4)
    pool = ranks(8)
    for n_slices, chips, chip_size, slice_size in pool.run(
            "multislice_shapes", 4):
        assert (n_slices, chips) == (mesh.shape["slice"],
                                     mesh.shape["chip"]) == (4, 2)
        assert (chip_size, slice_size) == (2, 4)
    for bad in (16, 0):
        with pytest.raises(ValueError) as e:
            JR.make_multislice_mesh(bad)
        # the same refusal, counting ranks where the reference counts
        # devices
        want = str(e.value).replace("devices", "ranks")
        assert pool.run("multislice_refusal", bad) == [want] * 8


def test_ring_attention_pattern_steps(ranks):
    jstep, jstate = JR.make_ring_attention_pattern(
        JR.make_seq_mesh(2), seq_per_device=16, heads=2, head_dim=8)
    want = jax.tree_util.tree_leaves(jstep(jstep(jstate)))[0].shape
    for shapes in ranks(2).run("pattern_steps", 16, 2, 8):
        # each rank's shard of the reference's (1, 32, 2, 8)
        assert shapes == [(1, 16, 2, 8)] * 3
        assert want == (1, 32, 2, 8)


# -- pipeline / expert parallel -------------------------------------------------

@pytest.mark.parametrize("n_dev", [2, 4, 8])
def test_pipeline_matches_sequential(ranks, n_dev):
    d, batch, M = 32, 3, 2 * n_dev + 1   # M not a multiple of n
    rng = _rng(20 + n_dev)
    w = (rng.standard_normal((n_dev, d, d)) / np.sqrt(d)).astype(np.float32)
    x = rng.standard_normal((M, batch, d)).astype(np.float32)
    mesh = JR.make_seq_mesh(n_dev, axis="stage")
    w_sh = jax.device_put(w, NamedSharding(mesh, P("stage", None, None)))
    want = np.asarray(JPP.pipeline_forward(x, w_sh, mesh))
    dense = np.asarray(JPP.pipeline_reference(x, w))
    for got in ranks(n_dev).run("pipeline_case", x, w):
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(got, dense, rtol=1e-4, atol=1e-4)


def test_pipeline_single_stage_degenerates(ranks):
    d = 16
    rng = _rng(4)
    w = rng.standard_normal((1, d, d)).astype(np.float32)
    x = rng.standard_normal((3, 2, d)).astype(np.float32)
    want = np.asarray(JPP.pipeline_forward(x, w, JR.make_seq_mesh(
        1, axis="stage")))
    got = ranks(2).run("pipeline_case", x, w, 1)
    assert got[1] is None
    np.testing.assert_allclose(got[0], want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n_dev", [2, 4])
def test_moe_alltoall_matches_dense(ranks, n_dev):
    d, c = 16, 3
    rng = _rng(5 + n_dev)
    w = (rng.standard_normal((n_dev, d, d)) / np.sqrt(d)).astype(np.float32)
    x = rng.standard_normal((n_dev * n_dev * c, d)).astype(np.float32)
    mesh = JR.make_seq_mesh(n_dev, axis="expert")
    w_sh = jax.device_put(w, NamedSharding(mesh, P("expert", None, None)))
    x_sh = jax.device_put(x, NamedSharding(mesh, P("expert", None)))
    want = np.asarray(JPP.moe_forward(x_sh, w_sh, mesh))
    got = np.concatenate(ranks(n_dev).run("moe_case", x, w), axis=0)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got, np.asarray(JPP.moe_reference(x, w, n_dev)),
                               rtol=1e-4, atol=1e-4)


def test_parallel_load_patterns_step_and_stay_bounded(ranks):
    """The reference's bounds at its test widths, over all 8 ranks: the
    pipeline's live microbatches (stage 0's shard) at unit RMS, every
    other shard zero; MoE's tokens at unit RMS."""

    outs = ranks(8).run("loads_bounded")
    for r, out in enumerate(outs):
        assert np.isfinite(out["pp"]).all() and np.isfinite(out["moe"]).all()
        if r == 0:
            live = float(np.sqrt((out["pp"] ** 2).mean()))
            assert 0.5 < live < 2.0
        else:
            assert float(np.abs(out["pp"]).max(initial=0.0)) == 0.0
    moe = np.concatenate([o["moe"] for o in outs])
    rms = float(np.sqrt((moe ** 2).mean()))
    assert 0.5 < rms < 2.0
