"""Dataset registry + cache: the ``dataset_Hypergraph`` equivalent.

Reference ``src/convert_datasets_to_pygDataset.py:39-178``: a whitelist of
16 dataset names, per-name dispatch to the right raw loader, per-noise
cache files for the synthetic-feature datasets, and a processed cache.
Here: npz caching of the HyperData (numpy-native, no torch/pickle
round-trips), the same name whitelist, the same p2raw layout rules
(``src/train.py:308-326``), and the same label fixups
(``src/train.py:328-339``).
"""

from __future__ import annotations

import os
import os.path as osp
from typing import Optional

import numpy as np

from allset_tpu.data.loaders import (
    load_LE_dataset,
    load_citation_dataset,
    load_cornell_dataset,
    load_yelp_dataset,
)
from allset_tpu.data.synthetic import synthetic_hypergraph
from allset_tpu.graph.transforms import HyperData

EXISTING_DATASETS = [
    "20newsW100", "ModelNet40", "zoo", "NTU2012", "Mushroom",
    "coauthor_cora", "coauthor_dblp",
    "yelp", "amazon-reviews", "walmart-trips", "house-committees",
    "walmart-trips-100", "house-committees-100",
    "cora", "citeseer", "pubmed",
]

SYNTHETIC_FEATURE_DATASETS = [
    "amazon-reviews", "walmart-trips", "house-committees",
    "walmart-trips-100", "house-committees-100",
]

# label rebasing rule of src/train.py:330-333
RELABEL_DATASETS = [
    "yelp", "walmart-trips", "house-committees",
    "walmart-trips-100", "house-committees-100",
]


def default_p2raw(name: str, root: str) -> str:
    if name in ("cora", "citeseer", "pubmed"):
        return osp.join(root, "cocitation")
    if name in ("coauthor_cora", "coauthor_dblp"):
        return osp.join(root, "coauthorship")
    if name == "yelp":
        return osp.join(root, "yelp")
    return root


def _cache_path(cache_dir: str, name: str, feature_noise: Optional[float]) -> str:
    suffix = f"_noise_{feature_noise}" if feature_noise is not None else ""
    return osp.join(cache_dir, f"{name}{suffix}.npz")


def save_hyperdata(path: str, data: HyperData) -> None:
    os.makedirs(osp.dirname(path), exist_ok=True)
    np.savez_compressed(
        path,
        x=data.x, y=data.y, node=data.node, edge=data.edge,
        num_nodes=data.num_nodes, num_hyperedges=data.num_hyperedges,
        **{f"extra_{k}": v for k, v in data.extras.items()},
    )


def load_hyperdata(path: str) -> HyperData:
    z = np.load(path)
    extras = {k[6:]: z[k] for k in z.files if k.startswith("extra_")}
    return HyperData(
        x=z["x"], y=z["y"], node=z["node"], edge=z["edge"],
        num_nodes=int(z["num_nodes"]), num_hyperedges=int(z["num_hyperedges"]),
        extras=extras,
    )


def load_dataset(
    name: str,
    root: str = "data/AllSet_all_raw_data",
    cache_dir: str = "data/cache",
    feature_noise: Optional[float] = None,
    seed: int = 0,
) -> HyperData:
    """Name-dispatched loader with npz cache and the reference's label
    fixups applied. 'synthetic'/'synthetic-large' generate data in-process
    (the raw archive is absent from this mount)."""
    if name.startswith("synthetic"):
        noise = feature_noise if feature_noise is not None else 1.0
        if name == "synthetic-walmart":
            # walmart-trips-100's published shape: power-law degrees,
            # 100-dim one-hot+noise features — the Table-2 protocol's
            # hard case, runnable without the raw archive
            from allset_tpu.data.synthetic import cornell_like_hypergraph

            return cornell_like_hypergraph(feature_noise=noise, seed=seed)
        if name == "synthetic-att":
            # attention-load-bearing band dataset (r5): hyperedges mix
            # anchor-class members with paired-class (a^1) imitators
            # plus a marker column only per-member attention can
            # exploit; at depth 1, mean pooling (what a broken PMA score
            # chain degenerates to) collides the paired classes and
            # loses ~15 accuracy points, so the AllSetTransformer band
            # TRIPS on attention-math bugs (data/synthetic.py
            # distractor_hypergraph docstring has the design history)
            from allset_tpu.data.synthetic import distractor_hypergraph

            return distractor_hypergraph(
                num_nodes=2000, num_hyperedges=1200, num_classes=4,
                avg_edge_size=12, distractor_frac=0.4,
                distractor_scale=2.0, feature_noise=noise, seed=seed,
            )
        if name == "synthetic-mid":
            # band-recording size: the 500-node
            # synthetic's 125-node test split makes cross-run std 3-8
            # accuracy points — too loose for a regression net. 2000
            # nodes quarters the per-node quantum and stabilizes the
            # planted-partition recovery, giving std ~1 point bands.
            return synthetic_hypergraph(
                num_nodes=2000, num_hyperedges=1200, num_classes=4,
                feature_noise=noise, seed=seed,
            )
        big = name.endswith("large")
        data = synthetic_hypergraph(
            num_nodes=20000 if big else 500,
            num_hyperedges=10000 if big else 300,
            num_classes=8 if big else 4,
            feature_noise=noise,
            seed=seed,
        )
        return data

    if name not in EXISTING_DATASETS:
        raise ValueError(f"unknown dataset {name!r}; known: {EXISTING_DATASETS}")

    needs_noise = name in SYNTHETIC_FEATURE_DATASETS
    cpath = _cache_path(cache_dir, name, feature_noise if needs_noise else None)
    if osp.exists(cpath):
        data = load_hyperdata(cpath)
    else:
        p2raw = default_p2raw(name, root)
        if name in ("cora", "citeseer", "pubmed", "coauthor_cora", "coauthor_dblp"):
            # coauthorship raws live under their bare names: coauthorship/
            # cora, coauthorship/dblp (convert_datasets_to_pygDataset.py:
            # 127-132 strips the prefix)
            raw_name = name.split("_")[-1] if name.startswith("coauthor") else name
            data = load_citation_dataset(p2raw, raw_name)
        elif name in ("20newsW100", "ModelNet40", "zoo", "NTU2012", "Mushroom"):
            data = load_LE_dataset(p2raw, name)
        elif name == "yelp":
            data = load_yelp_dataset(p2raw, name)
        else:  # cornell family
            base = name[:-4] if name.endswith("-100") else name
            fdim = 100 if name.endswith("-100") else None
            noise = feature_noise if feature_noise is not None else 1.0
            data = load_cornell_dataset(
                p2raw, base, feature_noise=noise, feature_dim=fdim, seed=seed
            )
        save_hyperdata(cpath, data)

    if name in RELABEL_DATASETS:
        # shift labels to start at 0 (src/train.py:330-333)
        data.y = data.y - data.y.min()
    return data
