"""Validate the accuracy bands actually catch numerics bugs.

Per-family sensitivity: for EVERY banded family, inject
deliberate bugs from the classes this codebase could realistically ship
(wrong norms, dropped activations, lost gradients, missing mediators)
and replay the FAST 5-run protocol of tests/test_bands.py with the
SHARED tolerance (record_bands.band_tolerance). The net works iff every
family lands OUTSIDE its tolerance for at least one injection.

Injections come in two forms:
  * config overrides — a wrong flag value reaching the factory
    (the reference's bug surface: ``src/train.py:221-287`` flags)
  * code patches — a context manager monkeypatching a module seam
    (this build's own bug surface: fused-GEMM packing, stop_gradient
    placement, norm pull-out scalings)

Measured-neutral injections are kept and reported: a bug the bands
cannot catch is recorded as such, not hidden (r4 found that the
deg_half_sym flag is a no-op for the flagship — PMA attention ignores
``norm`` entirely, faithful to ``src/layers.py:128-194``).

Run: python scripts/check_band_sensitivity.py [family ...]
"""

import contextlib
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from record_bands import band_tolerance, run_config

FAST_RUNS = 5


# ---- code-patch injections ------------------------------------------------

@contextlib.contextmanager
def _patch_uniform_attention():
    """PMA scores chain dead: leaky_relu(alpha) -> 0, so e = exp(0) = 1
    and attention degenerates to uniform mean pooling. The bug class is
    a lost score path in the fused [values | scores] GEMM packing
    (nn/modules.PMA slices columns by offset — one off-by-HC and the
    scores read the wrong columns)."""
    import jax.nn as fnn
    import jax.numpy as jnp

    orig = fnn.leaky_relu
    fnn.leaky_relu = lambda x, negative_slope=0.2: jnp.zeros_like(x)
    try:
        yield
    finally:
        fnn.leaky_relu = orig


@contextlib.contextmanager
def _patch_frozen_attention():
    """stop_gradient misplaced onto the scores (one line from the real
    gmax stop_gradient at nn/modules.py): attention weights stay at
    init, only the value path trains."""
    import jax.nn as fnn
    import jax

    orig = fnn.leaky_relu
    fnn.leaky_relu = lambda x, negative_slope=0.2: jax.lax.stop_gradient(
        orig(x, negative_slope)
    )
    try:
        yield
    finally:
        fnn.leaky_relu = orig


@contextlib.contextmanager
def _patch_hcha_no_norms():
    """HCHA's B^-1 / D^-1 scalings dropped (sum-sum aggregation): the
    norm pull-out refactor (models/hcha.py prop -> table scaling) makes
    exactly this one deleted line."""
    import jax.numpy as jnp

    from allset_tpu.models import hcha

    orig = hcha._safe_inv
    hcha._safe_inv = lambda x, power=1.0: jnp.where(
        x > 0, jnp.ones_like(x), jnp.zeros_like(x)
    )
    try:
        yield
    finally:
        hcha._safe_inv = orig


@contextlib.contextmanager
def _patch_hcha_squared_norms():
    """Degree powers doubled (D^-2, B^-2): a wrong-exponent bug in the
    same scaling."""
    from allset_tpu.models import hcha

    orig = hcha._safe_inv
    hcha._safe_inv = lambda x, power=1.0: orig(x, 2.0 * power)
    try:
        yield
    finally:
        hcha._safe_inv = orig


@contextlib.contextmanager
def _no_patch():
    yield


# ---- the injection table --------------------------------------------------
# family -> (band key, [(label, config_override or None, patch or None)])
# The flagship's injections run against the ATTENTION-LOAD-BEARING band
# (synthetic-att, r5): on synthetic-mid even a dead score chain measured
# inside the band (delta -0.60) — uniform attention solves plain planted
# partitions — so attention-math bugs are only catchable where attention
# changes accuracy (benchmarks/probe_att_task.py). The synthetic-mid
# flagship band stays in BANDS.json/test_bands as a general regression
# net; its measured-neutral injections are documented here.
INJECTIONS = {
    "AllSetTransformer": ("synthetic-att/AllSetTransformer", [
        ("dead-score-chain (uniform attention)", None,
         _patch_uniform_attention),
        ("stop_gradient-on-scores", None, _patch_frozen_attention),
        # r4/r5 measured-neutral on synthetic-mid, documented: normtype
        # is a NO-OP for the flagship (PMA ignores norm, faithful to the
        # reference); dead scores/frozen scores were inside ±2.82 there.
    ]),
    "AllDeepSets": ("synthetic-mid/AllDeepSets", [
        ("wrong-norm(deg_half_sym)", dict(normtype="deg_half_sym"), None),
    ]),
    "HCHA": ("synthetic-mid/HCHA", [
        ("wrong-norm(symdegnorm) [expected neutral]",
         dict(hcha_symdegnorm=True), None),
        ("squared-degree-powers", None, _patch_hcha_squared_norms),
        # 'dropped-B^-1/D^-1 (sum-sum)' measured NEUTRAL r5 (+1.12):
        # ELU + the classifier absorb a uniform scale at convergence.
    ]),
    "HNHN": ("synthetic-mid/HNHN", [
        ("wrong-degree-exponents (alpha=beta=0)",
         dict(hnhn_alpha=0.0, hnhn_beta=0.0), None),
    ]),
    # families added r5 — injections patched below
    "UniGCNII": ("synthetic-mid/UniGCNII", [
        ("degree-norms-dropped", None, None),
    ]),
    "CEGCN": ("synthetic-mid/CEGCN", [
        ("self-loops-dropped", None, None),
        # 'gcn_norm-dropped' (weights unnormalized, loops kept) measured
        # NEUTRAL r5 (+2.01 vs ±3.84).
    ]),
    "HyperGCN": ("synthetic-mid/HyperGCN", [
        ("mediators-dropped", dict(hypergcn_mediators=False), None),
    ]),
}


@contextlib.contextmanager
def _patch_unignn_no_degnorm():
    """UniGCNII's degV^-1/2 degE^-1/2 scalings replaced with ones (a
    dropped normalization in the preprocessing hand-off,
    ``src/train.py:396-412``). Patched at the factory's import site."""
    import numpy as np

    from allset_tpu.train import factory

    orig = factory.unignn_degrees

    def bad(hd):
        degV, degE = orig(hd)
        return np.ones_like(degV), np.ones_like(degE)

    factory.unignn_degrees = bad
    try:
        yield
    finally:
        factory.unignn_degrees = orig


@contextlib.contextmanager
def _patch_cegcn_no_gcn_norm():
    """Clique-expansion edge weights left unnormalized (gcn_norm dropped,
    reference ``src/preprocessing.py:466-468``): self-loops still added,
    but no d^-1/2 w d^-1/2. Patched at the factory's import site."""
    import numpy as np

    from allset_tpu.train import factory

    def bad(edge_index, edge_weight, num_nodes, add_self_loops=True):
        row, col = edge_index[0], edge_index[1]
        if edge_weight is None:
            edge_weight = np.ones(row.shape[0], dtype=np.float32)
        if add_self_loops:
            loop = np.arange(num_nodes, dtype=np.int64)
            row = np.concatenate([row, loop])
            col = np.concatenate([col, loop])
            edge_weight = np.concatenate(
                [edge_weight, np.ones(num_nodes, edge_weight.dtype)]
            )
        return np.stack([row, col]), edge_weight.astype(np.float32)

    orig = factory.gcn_norm
    factory.gcn_norm = bad
    try:
        yield
    finally:
        factory.gcn_norm = orig


@contextlib.contextmanager
def _patch_cegcn_no_self_loops():
    """gcn_norm called without the unit self-loops (reference appends
    them at ``src/preprocessing.py:466-468`` via PyG gcn_norm defaults):
    nodes lose their own features from the aggregation."""
    from allset_tpu.train import factory

    orig = factory.gcn_norm

    def bad(edge_index, edge_weight, num_nodes, add_self_loops=True):
        return orig(edge_index, edge_weight, num_nodes,
                    add_self_loops=False)

    factory.gcn_norm = bad
    try:
        yield
    finally:
        factory.gcn_norm = orig


INJECTIONS["UniGCNII"][1][0] = (
    "degree-norms-dropped", None, _patch_unignn_no_degnorm)
INJECTIONS["CEGCN"][1][0] = (
    "self-loops-dropped", None, _patch_cegcn_no_self_loops)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    bands = json.load(open(os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "BANDS.json")))
    families = [f for f, (key, _) in INJECTIONS.items()
                if key in bands and (not argv or f in argv)]
    missing = [f for f, (key, _) in INJECTIONS.items()
               if key not in bands and not argv]
    if missing:
        print(f"note: no recorded band yet for {missing} "
              "(scripts/record_bands.py)")

    results = {}
    for family in families:
        band_key, injections = INJECTIONS[family]
        band = bands[band_key]
        tol = band_tolerance(band["final_test_std"], FAST_RUNS, band["runs"])
        tripped = []
        for label, override, patch in injections:
            overrides = dict(band["overrides"], **(override or {}))
            ctx = patch() if patch else _no_patch()
            with ctx:
                rec = run_config(band["dataset"], band["method"], overrides,
                                 FAST_RUNS, band["epochs"],
                                 seed=band["seed"])
            delta = rec["final_test_mean"] - band["final_test_mean"]
            out = abs(delta) > tol
            tripped.append(out)
            print(f"{family:18s} {label:42s} mean "
                  f"{rec['final_test_mean']:6.2f} vs band "
                  f"{band['final_test_mean']:6.2f} ± {tol:.2f}  "
                  f"delta {delta:+6.2f}  -> "
                  f"{'TRIPPED' if out else 'inside'}", flush=True)
        results[family] = any(tripped)

    ok = [f for f, t in results.items() if t]
    bad = [f for f, t in results.items() if not t]
    print(f"\n{len(ok)}/{len(results)} families trip on at least one "
          f"injection{'; UNCAUGHT: ' + ', '.join(bad) if bad else ''}")
    return 0 if not bad else 1


if __name__ == "__main__":
    sys.exit(main())
