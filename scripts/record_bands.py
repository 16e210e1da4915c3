"""Record accuracy bands for the synthetic Table-2 protocol stand-ins.

The raw AllSet archive is absent from this mount, so real-dataset
accuracy parity cannot be pinned. This script is
the substitute regression net: it runs the full statistical protocol
(reference ``src/train.py:458-499`` semantics — fresh split + init per
run, best-val-epoch selection) on the synthetic stand-ins, and checks
the resulting mean ± std bands into ``BANDS.json``.
``tests/test_bands.py`` asserts future runs stay inside these bands.

Run on one accelerator:  python scripts/record_bands.py
"""

from __future__ import annotations

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# Each entry: (key, dataset, method, overrides, runs, epochs)
CONFIGS = [
    # the Table-2 hard case at full protocol scale (tuned walmart row)
    ("synthetic-walmart/AllSetTransformer",
     "synthetic-walmart", "AllSetTransformer",
     dict(heads=8, mlp_hidden=256, classifier_hidden=128,
          all_num_layers=1, mlp_num_layers=2, classifier_num_layers=1),
     20, 500),
    # method-family spread on synthetic-mid (2000 nodes — the 500-node synthetic's 125-node test split put 3-8
    # points of cross-run std in the bands, too loose to catch a
    # multi-point numerics regression; the 500-node test split is a
    # quarter of the quantum and the planted partition recovers stably).
    # lr=0.01 so every method converges well inside the epoch budget —
    # converged bands are tighter regression nets.
    ("synthetic-mid/AllSetTransformer", "synthetic-mid", "AllSetTransformer",
     dict(heads=4, mlp_hidden=64, classifier_hidden=64, lr=0.01), 20, 200),
    # all_num_layers=1 (the Table-2 depth): DeepSets aggregation
    # oversmooths the small synthetics at depth 2. Width 128: at 64 the
    # cross-run std is ~4 points (underfit runs scatter); 128 converges
    # uniformly (75.2 ± 1.6 over 20 runs).
    ("synthetic-mid/AllDeepSets", "synthetic-mid", "AllDeepSets",
     dict(mlp_hidden=128, classifier_hidden=128, lr=0.01,
          all_num_layers=1), 20, 200),
    ("synthetic-mid/HCHA", "synthetic-mid", "HCHA",
     dict(mlp_hidden=64, all_num_layers=2, lr=0.01), 20, 200),
    ("synthetic-mid/HNHN", "synthetic-mid", "HNHN",
     dict(mlp_hidden=64, all_num_layers=2, lr=0.01), 20, 200),
    # r5: attention-load-bearing flagship band — on synthetic-mid even a
    # DEAD score chain lands inside the band (uniform attention matches
    # learned attention on plain planted partitions), so attention-math
    # bugs need this row to trip (data/registry.py synthetic-att notes)
    # all_num_layers=1 (depth >= 2 gates distractor NODES through the
    # between-round nonlinearity without attention); lr=0.003 x 600
    # epochs (at lr=0.01 a minority of runs never escape the
    # uniform-attention plateau — 20-run std 12-18 points). Probe r5:
    # normal 99.00 ± 0.63 vs dead-score-chain 84.20 ± 2.29.
    ("synthetic-att/AllSetTransformer", "synthetic-att", "AllSetTransformer",
     dict(heads=4, mlp_hidden=64, classifier_hidden=64, lr=0.003,
          all_num_layers=1), 20, 600),
    # r5: every factory-reachable family gets a band
    ("synthetic-mid/UniGCNII", "synthetic-mid", "UniGCNII",
     dict(mlp_hidden=64, all_num_layers=2, lr=0.01), 20, 200),
    ("synthetic-mid/CEGCN", "synthetic-mid", "CEGCN",
     dict(mlp_hidden=64, all_num_layers=2, lr=0.01), 20, 200),
    ("synthetic-mid/HyperGCN", "synthetic-mid", "HyperGCN",
     dict(mlp_hidden=64, all_num_layers=2, lr=0.01), 20, 200),
]


def band_tolerance(std: float, fast_runs: int, runs: int) -> float:
    """Accuracy-band tolerance for a fast ``fast_runs``-run replay of a
    ``runs``-run recorded protocol: the recorded cross-run std plus 2x
    the sampling error of the difference of the two means, floored at 1
    accuracy point. SINGLE source of truth — tests/test_bands.py (the
    enforced net) and scripts/check_band_sensitivity.py (the validation
    that the net trips on injected bugs) must both use this, or the
    sensitivity check validates a different net than the one enforced
    (advisor r4)."""
    import numpy as np

    return max(2.0 * std * np.sqrt(1 / fast_runs + 1 / runs) + std, 1.0)


def run_config(dataset, method, overrides, runs, epochs, seed=0):
    from allset_tpu.data.registry import load_dataset
    from allset_tpu.train import TrainConfig, Trainer
    from allset_tpu.train.factory import ExperimentConfig, prepare

    data = load_dataset(dataset, feature_noise=1.0, seed=seed)
    kw = dict(dropout=0.5, lr=0.001, wd=0.0)
    kw.update(overrides)
    cfg = ExperimentConfig(
        method=method, dname=dataset, epochs=epochs, runs=runs,
        seed=seed, **kw,
    )
    model, batch, tx = prepare(cfg, data)
    trainer = Trainer(
        model, batch,
        TrainConfig(epochs=epochs, runs=runs, lr=cfg.lr, wd=cfg.wd,
                    seed=seed, vmap_runs=True),
        tx=tx,
    )
    res = trainer.fit()
    s = res.best_by_valid()
    return {
        "dataset": dataset, "method": method, "runs": runs,
        "epochs": epochs, "seed": seed, "overrides": overrides,
        "final_test_mean": round(s["final_test"][0], 3),
        "final_test_std": round(s["final_test"][1], 3),
        "highest_valid_mean": round(s["highest_valid"][0], 3),
        "highest_valid_std": round(s["highest_valid"][1], 3),
        "num_params": res.num_params,
        "wall_s": round(res.wall_time, 1),
    }


def main():
    import jax

    out_path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "BANDS.json")
    bands = {}
    if os.path.exists(out_path):
        bands = json.load(open(out_path))
    only = sys.argv[1:] or None
    for key, dataset, method, overrides, runs, epochs in CONFIGS:
        if only and not any(o in key for o in only):
            continue
        print(f"[bands] {key}: {runs} runs x {epochs} epochs ...", flush=True)
        rec = run_config(dataset, method, overrides, runs, epochs)
        rec["platform"] = jax.devices()[0].platform
        rec["device_kind"] = jax.devices()[0].device_kind  # beside wall_s
        bands[key] = rec
        print(f"[bands] {key}: test {rec['final_test_mean']} "
              f"± {rec['final_test_std']}", flush=True)
        with open(out_path, "w") as f:
            json.dump(bands, f, indent=1, sort_keys=True)
    print(f"wrote {out_path}")


if __name__ == "__main__":
    main()
