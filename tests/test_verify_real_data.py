"""End-to-end test of scripts/verify_real_data.py against a miniature
fake AllSet raw archive (the readiness harness must work the moment the
real archive lands)."""

import pickle

import numpy as np
import pytest


def _fake_archive(root):
    """Miniature raws for one dataset per loader family, in the real
    archive's layout (registry p2raw rules / src/train.py:308-326)."""
    rng = np.random.default_rng(0)

    # cocitation/cora (HyperGCN pickles)
    import scipy.sparse as sp

    d = root / "cocitation" / "cora"
    d.mkdir(parents=True)
    n = 40
    feats = sp.csr_matrix(rng.integers(0, 2, size=(n, 12)).astype(np.float32))
    with open(d / "features.pickle", "wb") as f:
        pickle.dump(feats, f)
    with open(d / "labels.pickle", "wb") as f:
        pickle.dump(list(rng.integers(0, 3, size=n)), f)
    hg = {f"e{j}": list(rng.choice(n, 3, replace=False)) for j in range(15)}
    with open(d / "hypergraph.pickle", "wb") as f:
        pickle.dump(hg, f)

    # coauthorship/cora — the BARE name (reference convert_datasets:127-132)
    d2 = root / "coauthorship" / "cora"
    d2.mkdir(parents=True)
    for fn in ("features.pickle", "labels.pickle", "hypergraph.pickle"):
        (d2 / fn).write_bytes((d / fn).read_bytes())

    # zoo (LE .content/.edges)
    d = root / "zoo"
    d.mkdir()
    nz, mz, fz = 10, 4, 6
    raw_ids = np.arange(7, 7 + nz + mz)
    rows = []
    for i, rid in enumerate(raw_ids):
        rows.append(" ".join([str(rid),
                              *map(str, rng.integers(0, 2, size=fz)),
                              str(i % 3)]))
    (d / "zoo.content").write_text("\n".join(rows) + "\n")
    pairs = []
    for j in range(mz):
        for v in rng.choice(nz, 3, replace=False):
            pairs.append(f"{raw_ids[v]} {raw_ids[nz + j]}")
    # the loader asserts every node id appears; append a catch-all edge
    missing = set(range(nz)) - {int(p.split()[0]) - 7 for p in pairs}
    for v in missing:
        pairs.append(f"{raw_ids[v]} {raw_ids[nz]}")
    (d / "zoo.edges").write_text("\n".join(pairs) + "\n")

    # walmart-trips (cornell)
    d = root / "walmart-trips"
    d.mkdir()
    nw = 12
    (d / "node-labels-walmart-trips.txt").write_text(
        "\n".join(str(i % 4 + 1) for i in range(nw)) + "\n"
    )
    hes = [",".join(str(v + 1) for v in rng.choice(nw, 3, replace=False))
           for _ in range(6)]
    hes.append(",".join(str(v + 1) for v in range(nw)))  # cover all nodes
    (d / "hyperedges-walmart-trips.txt").write_text("\n".join(hes) + "\n")


def test_verify_real_data_harness(tmp_path, capsys):
    import scripts.verify_real_data as vrd

    root = tmp_path / "archive"
    root.mkdir()
    _fake_archive(root)

    names = ["cora", "coauthor_cora", "zoo", "walmart-trips-100",
             "pubmed"]  # pubmed raw absent -> must report missing, not fail
    rc = vrd.main([
        "--data_root", str(root),
        "--cache_dir", str(tmp_path / "cache"),
        "--dnames", *names,
    ])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "[files] pubmed" in out and "MISSING" in out
    assert out.count("[load ]") == 4
    assert "readiness: 4/5 datasets load" in out
    # paper-stat WARN fires for the miniature cora (soft check works)
    assert "WARN expected" in out


@pytest.mark.slow
def test_verify_real_data_train_smoke(tmp_path, capsys):
    import scripts.verify_real_data as vrd

    root = tmp_path / "archive"
    root.mkdir()
    _fake_archive(root)
    rc = vrd.main([
        "--data_root", str(root),
        "--cache_dir", str(tmp_path / "cache"),
        "--dnames", "zoo",
        "--train", "--epochs", "2", "--runs", "1",
        "--res_root", str(tmp_path / "res"),
    ])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "[train] zoo" in out
    assert "FAILED" not in out
