"""Raw dataset loaders for the four AllSet formats.

Mirrors ``src/load_other_datasets.py`` behavior-for-behavior, but emits
:class:`HyperData` with node/hyperedge ids in separate 0-based id spaces
(the reference emits a symmetric [[V|E],[E|V]] list with offset hyperedge
ids, then slices the V2E half back out in ``ExtractV2E``; we skip the
round trip). All loaders coalesce (sort + dedup) incidence entries like
the reference's ``torch_sparse.coalesce`` calls.

The raw archive (``data/raw_data/AllSet_all_raw_data.zip``) is not in this
mount — these run whenever the files are present at the expected layout.
"""

from __future__ import annotations

import os
import os.path as osp
import pickle
from typing import Optional

import numpy as np

from allset_tpu.graph.transforms import HyperData, coalesce
from allset_tpu.utils import require


def load_LE_dataset(path: str, dataset: str = "ModelNet40") -> HyperData:
    """'.content'/'.edges' text datasets: NTU2012, ModelNet40, zoo,
    Mushroom, 20newsW100 (reference ``src/load_other_datasets.py:32-119``).

    .content rows: id, features..., label — covering BOTH node and
    hyperedge ids (features sliced to the first num_nodes rows).
    .edges rows: (node_id, hyperedge_id) with hyperedge ids offset.
    """
    content = np.genfromtxt(osp.join(path, dataset, f"{dataset}.content"), dtype=str)
    features = content[:, 1:-1].astype(np.float32)
    labels = content[:, -1].astype(float).astype(np.int64)

    idx = content[:, 0].astype(np.int32)
    idx_map = {j: i for i, j in enumerate(idx)}
    edges_un = np.genfromtxt(osp.join(path, dataset, f"{dataset}.edges"), dtype=np.int32)
    edges = np.array(
        [idx_map[v] for v in edges_un.flatten()], dtype=np.int64
    ).reshape(edges_un.shape)

    edge_index = edges.T  # [2, nnz]: row0 nodes, row1 offset hyperedge ids
    assert edge_index[0].max() == edge_index[1].min() - 1, "ids not contiguous"
    assert len(np.unique(edge_index)) == edge_index.max() + 1, "missing ids"

    num_nodes = int(edge_index[0].max()) + 1
    num_he = int(edge_index[1].max()) - num_nodes + 1
    node, edge = coalesce(edge_index[0], edge_index[1] - num_nodes)

    return HyperData(
        x=features[:num_nodes],
        y=labels[:num_nodes],
        node=node,
        edge=edge,
        num_nodes=num_nodes,
        num_hyperedges=num_he,
    )


def load_citation_dataset(path: str, dataset: str = "cora") -> HyperData:
    """HyperGCN-format pickles (cora/citeseer/pubmed cocitation,
    coauthor_cora/dblp): features.pickle (scipy sparse), labels.pickle,
    hypergraph.pickle ({he: [nodes]}) — reference
    ``src/load_other_datasets.py:121-196``."""
    with open(osp.join(path, dataset, "features.pickle"), "rb") as f:
        features = np.asarray(pickle.load(f).todense(), dtype=np.float32)
    with open(osp.join(path, dataset, "labels.pickle"), "rb") as f:
        labels = np.asarray(pickle.load(f), dtype=np.int64)
    num_nodes = features.shape[0]
    assert num_nodes == len(labels)

    with open(osp.join(path, dataset, "hypergraph.pickle"), "rb") as f:
        hypergraph = pickle.load(f)

    node_list, edge_list = [], []
    for he_id, he in enumerate(hypergraph.keys()):
        members = list(hypergraph[he])
        node_list += members
        edge_list += [he_id] * len(members)
    node, edge = coalesce(np.array(node_list), np.array(edge_list))

    return HyperData(
        x=features, y=labels, node=node, edge=edge,
        num_nodes=num_nodes, num_hyperedges=len(hypergraph),
    )


def load_yelp_dataset(
    path: str, dataset: str = "yelp", name_dictionary_size: int = 1000
) -> HyperData:
    """Yelp restaurants (reference ``src/load_other_datasets.py:198-291``):
    features = [latlong | state 1-hot | city 1-hot | name bag-of-words],
    labels = star bins, incidence from yelp_restaurant_incidence_H.csv."""
    pd = require("pandas", "loading the yelp dataset")
    CountVectorizer = require(
        "sklearn.feature_extraction.text", "loading the yelp dataset"
    ).CountVectorizer

    latlong = pd.read_csv(osp.join(path, "yelp_restaurant_latlong.csv")).values
    loc = pd.read_csv(osp.join(path, "yelp_restaurant_locations.csv"))
    state_int = loc.state_int.values
    city_int = loc.city_int.values
    num_nodes = loc.shape[0]

    state_1hot = np.zeros((num_nodes, state_int.max()))
    state_1hot[np.arange(num_nodes), state_int - 1] = 1
    city_1hot = np.zeros((num_nodes, city_int.max()))
    city_1hot[np.arange(num_nodes), city_int - 1] = 1

    vectorizer = CountVectorizer(
        max_features=name_dictionary_size, stop_words="english", strip_accents="ascii"
    )
    res_name = pd.read_csv(osp.join(path, "yelp_restaurant_name.csv")).values.flatten()
    name_bow = np.asarray(vectorizer.fit_transform(res_name).todense())

    features = np.hstack([latlong, state_1hot, city_1hot, name_bow]).astype(np.float32)
    labels = pd.read_csv(
        osp.join(path, "yelp_restaurant_business_stars.csv")
    ).values.flatten().astype(np.int64)
    assert num_nodes == len(labels)

    H = pd.read_csv(osp.join(path, "yelp_restaurant_incidence_H.csv"))
    node, edge = coalesce(H.node.values - 1, H.he.values - 1)

    return HyperData(
        x=features, y=labels, node=node, edge=edge,
        num_nodes=num_nodes, num_hyperedges=int(H.he.values.max()),
    )


def load_cornell_dataset(
    path: str,
    dataset: str = "amazon",
    feature_noise: float = 0.1,
    feature_dim: Optional[int] = None,
    seed: Optional[int] = None,
) -> HyperData:
    """Cornell datasets (walmart-trips / house-committees / amazon-reviews,
    reference ``src/load_other_datasets.py:293-386``): labels from text,
    synthetic features = one-hot(label) + N(0, feature_noise), optionally
    zero-padded to feature_dim (the '-100' variants); hyperedges
    one-per-line comma-separated; node ids shifted to start at 0."""
    pd = require("pandas", f"loading the {dataset} dataset")

    df_labels = pd.read_csv(
        osp.join(path, dataset, f"node-labels-{dataset}.txt"), names=["node_label"]
    )
    num_nodes = df_labels.shape[0]
    labels = df_labels.values.flatten().astype(np.int64)

    num_classes = int(labels.max())
    features = np.zeros((num_nodes, num_classes))
    features[np.arange(num_nodes), labels - 1] = 1.0
    if feature_dim is not None and feature_dim > num_classes:
        features = np.hstack(
            [features, np.zeros((num_nodes, feature_dim - num_classes))]
        )
    rng = np.random.default_rng(seed)
    features = rng.normal(features, feature_noise).astype(np.float32)

    node_list, he_list = [], []
    he_id = 0
    with open(osp.join(path, dataset, f"hyperedges-{dataset}.txt")) as f:
        for line in f:
            members = [int(x) for x in line.strip().split(",") if x]
            node_list += members
            he_list += [he_id] * len(members)
            he_id += 1
    node_arr = np.array(node_list)
    node_arr = node_arr - node_arr.min()  # shift to 0-based
    node, edge = coalesce(node_arr, np.array(he_list))

    return HyperData(
        x=features, y=labels, node=node, edge=edge,
        num_nodes=num_nodes, num_hyperedges=he_id,
    )
