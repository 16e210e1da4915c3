"""Accuracy-band regression tests against the recorded protocol bands.

``scripts/record_bands.py`` runs the full 20-run statistical protocol on
the synthetic Table-2 stand-ins and records mean ± std into
``BANDS.json``. These tests re-run a FAST subset (first 5 runs of the
same seed stream — the split/init sequence is a prefix of the recorded
protocol's) and assert the fast mean lands inside the recorded band.

This is the numerics regression net the missing raw archive prevents on
real datasets: a silently wrong norm, init, or
reduce shifts accuracy by many points and trips these.
"""

import json
import os

import numpy as np
import pytest

BANDS_PATH = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "BANDS.json")

FAST_RUNS = 5


def _band(key):
    if not os.path.exists(BANDS_PATH):
        pytest.skip("BANDS.json not recorded yet (scripts/record_bands.py)")
    bands = json.load(open(BANDS_PATH))
    if key not in bands:
        pytest.skip(f"no recorded band for {key}")
    return bands[key]


@pytest.mark.slow
@pytest.mark.parametrize("key", [
    "synthetic-mid/AllSetTransformer", "synthetic-mid/AllDeepSets",
    "synthetic-mid/HCHA", "synthetic-mid/HNHN", "synthetic-mid/UniGCNII",
    "synthetic-mid/CEGCN", "synthetic-mid/HyperGCN",
    # attention-load-bearing flagship row (r5): the band whose trips
    # prove attention-math regressions (scripts/check_band_sensitivity)
    "synthetic-att/AllSetTransformer",
])
def test_synthetic_band(key):
    import sys

    sys.path.insert(0, os.path.join(os.path.dirname(BANDS_PATH), "scripts"))
    from record_bands import band_tolerance, run_config

    method = key.split("/")[1]
    band = _band(key)
    rec = run_config(
        band["dataset"], band["method"], band["overrides"],
        FAST_RUNS, band["epochs"], seed=band["seed"],
    )
    # tolerance shared with scripts/check_band_sensitivity.py so the
    # sensitivity check validates exactly this net
    tol = band_tolerance(band["final_test_std"], FAST_RUNS, band["runs"])
    assert abs(rec["final_test_mean"] - band["final_test_mean"]) <= tol, (
        f"{method}: fast-mean {rec['final_test_mean']} outside recorded "
        f"band {band['final_test_mean']} ± {tol:.2f}"
    )
