"""The port's dp x tp sharded model (``tpumon_torch.loadgen.model``:
``make_mesh``, ``shard_params``, the four conjugates, ``sharded_train_step``)
against the JAX package's (``tpumon.loadgen.model``) on conftest's 8
virtual CPU devices.

The port runs on gloo ranks (``tests/test_torch_ranks.py``, one pool of
processes per world size for the module), the JAX side here; both get the
same numpy parameters (a JAX init) and tokens.  Tolerances, each the bar
of the unsharded port's own tests:

* shards: exact (``array_equal``) against the JAX ``NamedSharding`` shard
  at the same mesh position;
* one layer in f32: rtol = atol = 1e-5 (``test_torch_model.py``'s layer
  bar: f32 summation order, now also split over the model group);
* one step: the loss within rtol 2e-2 (``test_loadgen.py``'s sharded
  bar), every updated parameter, gathered whole, within atol 5e-6
  (``test_torch_model.py``'s step bar).  A ``gather_from`` whose backward
  sums instead of keeping its block must fail that comparison.

The dry run's per-rank checks (``tpumon_torch.entry``) run on the pools
too, each beside what the reference computes for the same n.
"""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
from jax.sharding import NamedSharding  # noqa: E402

from tpumon import collectives as RC  # noqa: E402
from tpumon.loadgen import model as JM  # noqa: E402
from tpumon.loadgen import ring as JR  # noqa: E402
from tpumon_torch import collectives as C  # noqa: E402
from tpumon_torch import entry as E  # noqa: E402
from tpumon_torch.loadgen import model as TM  # noqa: E402
from test_torch_ranks import RankPool  # noqa: E402

ATTN = [pytest.param(False, id="dense"), pytest.param(True, id="flash")]
STEP_ATOL = 5e-6


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


def _cfg(flash):
    return dataclasses.replace(JM.ModelConfig.tiny(), flash=flash)


def _inputs(n, batch=None):
    """(numpy params of a JAX init, tokens of ``max(dp * 2, 4)`` rows)."""

    cfg = JM.ModelConfig.tiny()
    pj = JM.init_params(jax.random.PRNGKey(0), cfg)
    dp = JM.make_mesh(n).devices.shape[0]
    tokens = np.random.default_rng(1).integers(
        0, cfg.vocab, (batch or max(dp * 2, 4), cfg.seq_len)).astype(np.int32)
    return jax.tree_util.tree_map(np.asarray, pj), tokens


_JAX_STEPS = {}


def _jax_step(n, flash):
    """The reference's sharded step on the n-device mesh -> (numpy params
    before it, tokens, numpy params after it, loss)."""

    if (n, flash) not in _JAX_STEPS:
        cfg = _cfg(flash)
        np_params, tokens = _inputs(n)
        mesh = JM.make_mesh(n)
        with mesh:
            sp = JM.shard_params(jax.tree_util.tree_map(jax.numpy.asarray,
                                                        np_params), mesh, cfg)
            st = jax.device_put(tokens, NamedSharding(mesh, JM.batch_spec()))
            new, loss = JM.sharded_train_step(cfg, mesh)(sp, st)
        _JAX_STEPS[n, flash] = (np_params, tokens,
                                jax.tree_util.tree_map(np.asarray, new),
                                float(loss))
    return _JAX_STEPS[n, flash]


def _leaf(tree, path):
    for key in path:
        tree = tree[key.key]
    return tree


def _step_errors(got_params, want_params):
    return {jax.tree_util.keystr(path): float(np.abs(
        _leaf(got_params, path) - leaf).max())
        for path, leaf in jax.tree_util.tree_leaves_with_path(want_params)}


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_mesh_matches_reference(ranks, n):
    """Same factorization, and rank r at the reference's device r's
    position: the data group is its mesh column, the model group its
    row."""

    devices = JM.make_mesh(n).devices
    ids = np.vectorize(lambda d: d.id)(devices)
    outs = ranks(max(n, 2)).run("mesh_case", n)
    assert all(o is None for o in outs[n:])
    for r, (shape, data, model) in enumerate(outs[:n]):
        assert shape == devices.shape == TM.mesh_shape(n)
        d, m = np.argwhere(ids == r)[0]
        assert data == tuple(ids[:, m]) and model == tuple(ids[d, :])


@pytest.mark.parametrize("n", [2, 4, 8])
def test_shards_equal_the_reference_shards(ranks, n):
    np_params, tokens = _inputs(n)
    mesh = JM.make_mesh(n)
    ids = np.vectorize(lambda d: d.id)(mesh.devices)
    tp = mesh.devices.shape[1]
    outs = ranks(n).run("shard_case", np_params, tokens, n)
    specs = JM.param_specs(JM.ModelConfig.tiny())
    checked = 0
    for path, leaf in jax.tree_util.tree_leaves_with_path(np_params):
        arr = jax.device_put(leaf, NamedSharding(mesh, _leaf(specs, path)))
        for sh in arr.addressable_shards:
            d, m = np.argwhere(ids == sh.device.id)[0]
            got = _leaf(outs[d * tp + m][0], path)
            assert np.array_equal(got, np.asarray(sh.data)), path
            checked += 1
    arr = jax.device_put(tokens, NamedSharding(mesh, JM.batch_spec()))
    for sh in arr.addressable_shards:
        d, m = np.argwhere(ids == sh.device.id)[0]
        assert np.array_equal(outs[d * tp + m][1], np.asarray(sh.data))
    assert checked == n * len(jax.tree_util.tree_leaves(np_params))


@pytest.mark.parametrize("flash", ATTN)
@pytest.mark.parametrize("n", [2, 4, 8])
def test_sharded_layer_matches_jax_in_f32(ranks, n, flash):
    cfg = _cfg(flash)
    np_params, _ = _inputs(n)
    layer = {k: np.array(v[0]) for k, v in np_params["layers"].items()}
    x = (0.05 * np.random.default_rng(2).standard_normal(
        (4, cfg.seq_len, cfg.d_model))).astype(np.float32)
    want = np.asarray(JM._layer(cfg, jax.numpy.asarray(x), layer))
    dp = JM.make_mesh(n).devices.shape[0]
    tp = n // dp
    outs = ranks(n).run("sharded_layer_case", layer, x, flash, n)
    for r, got in enumerate(outs):
        rows = want.shape[0] // dp
        d = r // tp
        np.testing.assert_allclose(got, want[d * rows:(d + 1) * rows],
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("flash", ATTN)
@pytest.mark.parametrize("n", [2, 4, 8])
def test_sharded_step_matches_jax(ranks, n, flash):
    np_params, tokens, want, loss_j = _jax_step(n, flash)
    outs = ranks(n).run("sharded_step_case", np_params, tokens, flash, n)
    for loss, got in outs:
        np.testing.assert_allclose(loss, loss_j, rtol=2e-2)
        errs = _step_errors(got, want)
        assert max(errs.values()) <= STEP_ATOL, errs
        # every leaf moved
        for path, leaf in jax.tree_util.tree_leaves_with_path(np_params):
            assert np.any(_leaf(got, path) != leaf), path


@pytest.mark.parametrize("n", [2, 4, 8])
def test_planted_gather_fault_fails_the_comparison(ranks, n):
    """A ``gather_from`` whose backward sums its gradient over the model
    group (tp >= 2 at every n here) leaves the loss in its bar but moves
    the parameters past the step's."""

    np_params, tokens, want, loss_j = _jax_step(n, False)
    outs = ranks(n).run("sharded_step_case", np_params, tokens, False, n,
                        True)
    for loss, got in outs:
        np.testing.assert_allclose(loss, loss_j, rtol=2e-2)
        assert max(_step_errors(got, want).values()) > STEP_ATOL


@pytest.mark.parametrize("flash", ATTN)
def test_unsharded_mesh_computes_train_step_exactly(ranks, flash):
    np_params, tokens = _inputs(1, batch=4)
    outs = ranks(2).run("unsharded_equal_case", np_params, tokens, flash)
    assert outs[0] == (True, True) and outs[1] is None


def test_gradient_sync_attribution_equals_the_ring_bound(ranks):
    """At (dp, tp) = (2, 2): every collective of one step sits in a
    declared group, every one gloo ran is attributed, and the gradient
    sync is one all-reduce over the data group of every gradient shard
    (S their bytes summed), attributed ``2 * S * (dp - 1) / dp``."""

    np_params, tokens = _inputs(4)
    dp = 2
    for recs, sync, shard_bytes, seen, world in ranks(4).run(
            "sharded_attribution_case", np_params, tokens):
        assert world == 4
        recs = [C.CommRecord(*r) for r in recs]
        sync = [C.CommRecord(*r) for r in sync]
        assert recs and all(r.n is not None for r in recs)
        assert len(recs) == len(seen)
        (r,) = sync
        assert (r.kind, r.n, r.dcn) == ("allreduce", dp, False)
        assert r.payload == sum(shard_bytes)
        assert r.wire == int(2 * sum(shard_bytes) * (dp - 1) / dp)


# ---- the dry run's checks ---------------------------------------------------------

@pytest.mark.parametrize("n", [2, 4, 8])
def test_dryrun_allreduce_bytes_match_the_reference(ranks, n):
    """The port's attributed bytes of one all-reduce load step equal the
    reference's attribution of its compiled step on n devices."""

    step, state = JR.ring_allreduce_load(JR.make_seq_mesh(n, axis="data"),
                                         mb_per_device=1)
    want = RC.module_wire_bytes(step.lower(state).compile().as_text())
    assert ranks(n).run("dryrun_check", "check_allreduce_bytes") == \
        [want] * n


@pytest.mark.parametrize("n", [4, 8])
def test_dryrun_participant_order(ranks, n):
    perm = E.permuted_ranks(n)
    for r, seen in enumerate(ranks(n).run("dryrun_check",
                                          "check_participant_order")):
        assert seen["ranks"] == perm
        # the backend's own group lists its ranks sorted: the order lives
        # in Group1D.ranks alone
        assert seen["backend_ranks"] == sorted(perm)
        assert seen["from"] == perm[(perm.index(r) - 1) % n]


@pytest.mark.parametrize("n", [2, 4, 8])
def test_dryrun_multislice_split_is_the_gloo_ring_bound(ranks, n):
    """gloo's split: the reduce-scatter counted as the all-reduce gloo ran
    over the whole input; the reference's compiled RS counts half of
    that on ICI, and the DCN share is the same on both."""

    chips = n // 2
    got = ranks(n).run("dryrun_check", "check_multislice_split")
    assert got == [E.multislice_bound(2, chips, "gloo")] * n
    mesh = JR.make_multislice_mesh(2, chips)
    step, state = JR.dcn_allreduce_load(mesh, mb_per_device=1)
    slice_row = {d.id: s for s in range(2) for d in mesh.devices[s]}
    ici, dcn = RC.module_wire_bytes_split(
        step.lower(state).compile().as_text(),
        slice_of=slice_row.__getitem__)
    assert dcn == got[0][1]
    assert ici == E.multislice_bound(2, chips, "nccl")[0]


def test_dryrun_modeled_links_on_a_rank(ranks):
    for modeled in ranks(2).run("dryrun_check", "check_modeled_links"):
        assert len(modeled) == 8
