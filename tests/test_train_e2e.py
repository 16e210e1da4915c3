"""End-to-end training tests: the accuracy-band protocol of the reference
(20-run mean ± std, best-val-epoch selection) on a learnable synthetic
hypergraph (SURVEY.md §4 implication (5))."""

import numpy as np

import pytest
import jax.numpy as jnp

from allset_tpu.data.synthetic import synthetic_hypergraph
from allset_tpu.graph import add_self_loops, norm_construction
from allset_tpu.graph.batch import Batch
from allset_tpu.models import SetGNN, SetGNNConfig
from allset_tpu.train import TrainConfig, Trainer

pytestmark = pytest.mark.slow  # e2e / multi-device: see pytest.ini


def make_batch(seed=0, noise=0.5):
    hd = synthetic_hypergraph(
        num_nodes=120, num_hyperedges=60, num_classes=3,
        homophily=0.9, feature_noise=noise, seed=seed,
    )
    hd = norm_construction(add_self_loops(hd), "all_one")
    return Batch.from_hyperdata(hd), hd


def test_alldeepsets_learns():
    batch, hd = make_batch()
    cfg = SetGNNConfig.all_deep_sets(
        num_features=hd.num_features, num_classes=hd.num_classes,
        all_num_layers=1, mlp_hidden=32, classifier_hidden=32,
        classifier_num_layers=1,
    )
    trainer = Trainer(SetGNN(cfg), batch, TrainConfig(epochs=60, runs=3, lr=0.01))
    res = trainer.fit()
    stats = res.best_by_valid()
    mean_test, _ = stats["final_test"]
    assert mean_test > 60.0, f"AllDeepSets failed to learn: {mean_test}"
    assert res.num_params > 0


def test_allsettransformer_learns():
    batch, hd = make_batch()
    cfg = SetGNNConfig(
        num_features=hd.num_features, num_classes=hd.num_classes,
        all_num_layers=1, mlp_hidden=32, classifier_hidden=32,
        classifier_num_layers=1, heads=4,
    )
    trainer = Trainer(SetGNN(cfg), batch, TrainConfig(epochs=60, runs=3, lr=0.01))
    res = trainer.fit()
    mean_test, _ = res.best_by_valid()["final_test"]
    assert mean_test > 60.0, f"AllSetTransformer failed to learn: {mean_test}"


def test_vmap_and_sequential_runs_agree():
    """vmapped parallel runs must be statistically identical machinery to
    sequential runs — same rngs, same splits => same metrics."""
    batch, hd = make_batch()
    cfg = SetGNNConfig.all_deep_sets(
        num_features=hd.num_features, num_classes=hd.num_classes,
        all_num_layers=1, mlp_hidden=16, classifier_num_layers=1,
    )
    tc = dict(epochs=10, runs=2, lr=0.01, seed=42)
    res_v = Trainer(SetGNN(cfg), batch, TrainConfig(vmap_runs=True, **tc)).fit()
    res_s = Trainer(SetGNN(cfg), batch, TrainConfig(vmap_runs=False, **tc)).fit()
    np.testing.assert_allclose(res_v.metrics, res_s.metrics, rtol=1e-4, atol=1e-5)


def test_bn_normalization_trains():
    """BatchNorm path exercises the mutable batch_stats plumbing."""
    batch, hd = make_batch()
    cfg = SetGNNConfig.all_deep_sets(
        num_features=hd.num_features, num_classes=hd.num_classes,
        all_num_layers=1, mlp_hidden=16, normalization="bn",
        classifier_num_layers=1,
    )
    res = Trainer(SetGNN(cfg), batch, TrainConfig(epochs=20, runs=2, lr=0.01)).fit()
    assert np.all(np.isfinite(res.metrics))


def test_bfloat16_mixed_precision_learns():
    """bf16 activations / f32 params+softmax: the mixed-precision config."""
    batch, hd = make_batch()
    cfg = SetGNNConfig(
        num_features=hd.num_features, num_classes=hd.num_classes,
        all_num_layers=1, mlp_hidden=32, classifier_hidden=32,
        classifier_num_layers=1, heads=4, dtype="bfloat16",
    )
    res = Trainer(SetGNN(cfg), batch, TrainConfig(epochs=60, runs=2, lr=0.01)).fit()
    assert np.all(np.isfinite(res.metrics))
    mean_test, _ = res.best_by_valid()["final_test"]
    assert mean_test > 60.0, f"bf16 failed to learn: {mean_test}"


def test_zoo_bfloat16_trains():
    """Mixed-precision zoo models learn on the synthetic task."""
    from allset_tpu.data.synthetic import synthetic_hypergraph
    from allset_tpu.train import TrainConfig, Trainer
    from allset_tpu.train.factory import ExperimentConfig, prepare

    hd = synthetic_hypergraph(
        num_nodes=120, num_hyperedges=60, num_classes=3, feature_dim=16, seed=3
    )
    for method in ("HCHA", "HNHN", "UniGCNII"):
        cfg = ExperimentConfig(
            method=method, epochs=60, runs=1, all_num_layers=2,
            mlp_hidden=32, dtype="bfloat16",
        )
        model, batch, tx = prepare(cfg, hd)
        res = Trainer(
            model, batch,
            TrainConfig(epochs=60, runs=1, lr=0.01, wd=0.0, seed=0),
            tx=tx,
        ).fit()
        acc = res.best_by_valid()["final_train"][0]
        assert acc > 50.0, f"{method} bf16 failed to learn: {acc}"


def test_remat_matches_no_remat():
    """jax.checkpoint must not change the math (activations recomputed)."""
    from allset_tpu.data.synthetic import synthetic_hypergraph
    from allset_tpu.train import TrainConfig, Trainer
    from allset_tpu.train.factory import ExperimentConfig, prepare

    hd = synthetic_hypergraph(
        num_nodes=80, num_hyperedges=40, num_classes=3, feature_dim=12, seed=5
    )
    res = []
    for remat in (False, True):
        cfg = ExperimentConfig(method="AllSetTransformer", epochs=20, runs=1,
                               all_num_layers=1, mlp_hidden=16, heads=2)
        model, batch, tx = prepare(cfg, hd)
        r = Trainer(
            model, batch,
            TrainConfig(epochs=20, runs=1, lr=0.01, wd=0.0, seed=0, remat=remat),
            tx=tx,
        ).fit()
        res.append(r.metrics)
    np.testing.assert_allclose(res[0], res[1], rtol=1e-4, atol=1e-5)


def test_vmap_chunked_matches_full():
    """vmap_chunk groups must reproduce the full-vmap protocol exactly
    (runs are independent; concat along the runs axis)."""
    import numpy as np

    from allset_tpu.data.registry import load_dataset
    from allset_tpu.train.factory import ExperimentConfig, prepare
    from allset_tpu.train.trainer import TrainConfig, Trainer

    cfg = ExperimentConfig(dname="synthetic", method="AllSetTransformer",
                           epochs=5, runs=4, mlp_hidden=32)
    data = load_dataset("synthetic", feature_noise=1.0)
    model, batch, _ = prepare(cfg, data)
    tcfg_kw = dict(epochs=5, runs=4, train_prop=0.5, valid_prop=0.25, seed=0)

    r_full = Trainer(model, batch, TrainConfig(**tcfg_kw)).fit()
    r_chunk = Trainer(
        model, batch, TrainConfig(vmap_chunk=3, **tcfg_kw)
    ).fit()
    # the runs-fold width (R*F vs chunk*F) changes f32 accumulation
    # order, so losses match to ~1e-3 relative; accuracies must be equal
    np.testing.assert_array_equal(
        r_full.metrics[..., :3], r_chunk.metrics[..., :3]
    )
    np.testing.assert_allclose(
        r_full.metrics[..., 3:], r_chunk.metrics[..., 3:], rtol=2e-3
    )


def test_epoch_segmented_matches_single_call():
    """Epoch-segmented execution (--epoch_chunk) must be
    bit-identical to the one-call scan: same rng stream, same step fn."""
    import numpy as np

    from allset_tpu.data.registry import load_dataset
    from allset_tpu.train.factory import ExperimentConfig, prepare
    from allset_tpu.train.trainer import TrainConfig, Trainer

    cfg = ExperimentConfig(dname="synthetic", method="AllSetTransformer",
                           epochs=7, runs=2, mlp_hidden=32)
    data = load_dataset("synthetic", feature_noise=1.0)
    model, batch, _ = prepare(cfg, data)
    kw = dict(epochs=7, runs=2, seed=0)

    r_one = Trainer(model, batch, TrainConfig(**kw)).fit()
    r_seg = Trainer(model, batch, TrainConfig(epoch_chunk=3, **kw)).fit()
    np.testing.assert_array_equal(r_one.metrics, r_seg.metrics)

    # eval_every > 1 carries the last metrics across segment boundaries
    r_one = Trainer(model, batch, TrainConfig(eval_every=2, **kw)).fit()
    r_seg = Trainer(
        model, batch, TrainConfig(eval_every=2, epoch_chunk=3, **kw)
    ).fit()
    np.testing.assert_array_equal(r_one.metrics, r_seg.metrics)


def test_epoch_segmented_sequential_matches():
    """Sequential (no-vmap) runs segment identically too."""
    import numpy as np

    from allset_tpu.data.registry import load_dataset
    from allset_tpu.train.factory import ExperimentConfig, prepare
    from allset_tpu.train.trainer import TrainConfig, Trainer

    cfg = ExperimentConfig(dname="synthetic", method="AllSetTransformer",
                           epochs=6, runs=2, mlp_hidden=32)
    data = load_dataset("synthetic", feature_noise=1.0)
    model, batch, _ = prepare(cfg, data)
    kw = dict(epochs=6, runs=2, seed=0, vmap_runs=False)
    r_one = Trainer(model, batch, TrainConfig(**kw)).fit()
    r_seg = Trainer(model, batch, TrainConfig(epoch_chunk=4, **kw)).fit()
    np.testing.assert_array_equal(r_one.metrics, r_seg.metrics)


def test_fit_chunked_oom_retry_keeps_finished_groups():
    """An OOM in group k halves the chunk and retries THAT group —
    finished groups are not re-run (code-review r2 finding)."""
    import numpy as np

    from allset_tpu.data.registry import load_dataset
    from allset_tpu.train.factory import ExperimentConfig, prepare
    from allset_tpu.train.trainer import TrainConfig, Trainer

    cfg = ExperimentConfig(dname="synthetic", method="AllSetTransformer",
                           epochs=3, runs=6, mlp_hidden=16)
    data = load_dataset("synthetic", feature_noise=1.0)
    model, batch, _ = prepare(cfg, data)
    tr = Trainer(model, batch, TrainConfig(epochs=3, runs=6, vmap_chunk=4,
                                           seed=0))

    import jax

    real_fn = jax.jit(jax.vmap(tr._run, in_axes=(0, 0, None)))
    calls = []

    def flaky_fn(rngs, masks, b):
        calls.append(int(rngs.shape[0]))
        if len(calls) == 2:  # second group OOMs once
            raise RuntimeError("RESOURCE_EXHAUSTED: fake HBM OOM")
        return real_fn(rngs, masks, b)

    y = np.asarray(batch.y)
    rng = np.random.default_rng(0)
    from allset_tpu.graph.batch import split_masks
    from allset_tpu.graph.transforms import rand_train_test_idx

    import jax.numpy as jnp

    masks = jax.tree_util.tree_map(
        lambda *xs: jnp.stack(xs),
        *[split_masks(rand_train_test_idx(y, 0.5, 0.25, rng=rng),
                      batch.num_nodes) for _ in range(6)],
    )
    rngs = jax.random.split(jax.random.PRNGKey(0), 6)
    metrics, params = tr._fit_chunked(flaky_fn, rngs, masks, 4)
    # group1 (4 runs), group2 OOM, retried at 2, then 2 more passes
    assert calls == [4, 2, 2], calls
    assert metrics.shape[0] == 6
    ref, _ = tr._fit_chunked(real_fn, rngs, masks, 6)
    np.testing.assert_array_equal(
        np.asarray(metrics[..., :3]), np.asarray(ref[..., :3])
    )
