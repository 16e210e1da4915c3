"""Trainer host-side sizing: the vmapped-runs group size follows the
device's reported memory limit."""

from allset_tpu.train import TrainConfig, Trainer


def test_initial_chunk_from_device_memory_limit(monkeypatch):
    """The vmapped-runs group size divides half the device's reported
    memory limit by the per-run live-set estimate; a backend that reports
    no limit gets every run at once; an explicit vmap_chunk wins."""
    from allset_tpu.data.registry import load_dataset
    from allset_tpu.train import trainer as tr_mod
    from allset_tpu.train.factory import ExperimentConfig, prepare

    cfg = ExperimentConfig(dname="synthetic", method="AllSetTransformer",
                           mlp_hidden=16, heads=2)
    model, batch, _ = prepare(cfg, load_dataset("synthetic", feature_noise=1.0))
    inc = batch.inc
    per_run = (3 * inc.nnz * (16 + 2) * 4
               + 4 * (inc.num_nodes + inc.num_edges) * 16 * 4)
    tr = Trainer(model, batch, TrainConfig(epochs=1, runs=20))
    monkeypatch.setattr(tr_mod, "_device_memory_limit", lambda: 14 * per_run)
    assert tr._initial_chunk() == 7
    monkeypatch.setattr(tr_mod, "_device_memory_limit", lambda: 10**15)
    assert tr._initial_chunk() == 20
    monkeypatch.setattr(tr_mod, "_device_memory_limit", lambda: 1)
    assert tr._initial_chunk() == 1
    monkeypatch.setattr(tr_mod, "_device_memory_limit", lambda: None)
    assert tr._initial_chunk() == 20
    tr3 = Trainer(model, batch, TrainConfig(epochs=1, runs=20, vmap_chunk=3))
    assert tr3._initial_chunk() == 3
