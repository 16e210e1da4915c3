"""Probe: find a synthetic task where PMA attention is LOAD-BEARING.

On synthetic-mid (homophily 0.8) a dead score chain (uniform attention)
costs the flagship only -0.6 accuracy points — converged mean pooling
solves the planted partition, so NO attention-math bug can trip that
band (r5 sensitivity run). A regression net for attention numerics
needs a task where attention changes accuracy: lower homophily makes
hyperedges mixed-class, so weighting same-class members over outliers
(what PMA can learn, mean pooling cannot) should open a gap.

Sweeps homophily x avg_edge_size, training the flagship normally and
with the dead-score injection (5 fast runs each), printing the gap.
"""

import contextlib
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


@contextlib.contextmanager
def dead_scores():
    import jax.nn as fnn
    import jax.numpy as jnp

    orig = fnn.leaky_relu
    fnn.leaky_relu = lambda x, negative_slope=0.2: jnp.zeros_like(x)
    try:
        yield
    finally:
        fnn.leaky_relu = orig


def run(hd, runs=5, epochs=200):
    from allset_tpu.train import TrainConfig, Trainer
    from allset_tpu.train.factory import ExperimentConfig, prepare

    cfg = ExperimentConfig(
        method="AllSetTransformer", epochs=epochs, runs=runs, seed=0,
        heads=4, mlp_hidden=64, classifier_hidden=64, lr=0.01,
        dropout=0.5, wd=0.0,
    )
    model, batch, tx = prepare(cfg, hd)
    tr = Trainer(model, batch,
                 TrainConfig(epochs=epochs, runs=runs, lr=0.01, wd=0.0,
                             seed=0, vmap_runs=True), tx=tx)
    s = tr.fit().best_by_valid()
    return s["final_test"]


def main():
    import json

    from allset_tpu.data.synthetic import (
        distractor_hypergraph, synthetic_hypergraph,
    )

    if os.environ.get("PROBE_DISTRACTOR"):
        for dfrac in (0.4, 0.5):
            for dscale in (2.0, 3.0):
                hd = distractor_hypergraph(
                    num_nodes=2000, num_hyperedges=1200, num_classes=4,
                    avg_edge_size=12, distractor_frac=dfrac,
                    distractor_scale=dscale, seed=0,
                )
                m0, s0 = run(hd)
                with dead_scores():
                    m1, s1 = run(hd)
                print(f"dfrac={dfrac} dscale={dscale}: normal "
                      f"{m0:.2f}±{s0:.2f}  uniform-att {m1:.2f}±{s1:.2f}  "
                      f"gap {m0-m1:+.2f}", flush=True)
        return

    for hom in (0.4, 0.55, 0.7):
        for esz in (5, 15):
            hd = synthetic_hypergraph(
                num_nodes=2000, num_hyperedges=1200, num_classes=4,
                avg_edge_size=esz, homophily=hom, feature_noise=1.0,
                seed=0,
            )
            m0, s0 = run(hd)
            with dead_scores():
                m1, s1 = run(hd)
            print(f"hom={hom} esz={esz}: normal {m0:.2f}±{s0:.2f}  "
                  f"uniform-att {m1:.2f}±{s1:.2f}  gap {m0-m1:+.2f}",
                  flush=True)


if __name__ == "__main__":
    main()
