"""HyperGCN: non-uniform hypergraph Laplacian graph approximation.

Reference ``src/models.py:29-77`` + ``src/utils.py:11-263``. Per hyperedge,
member features are projected on a random vector; the argmax/argmin
("supremum/infimum") pair is connected, plus optional mediator edges with
weight 1/(2k-3); the resulting graph is symmetrically normalized with unit
self-loops. Convolution is A @ (X W) + b.

Two modes (``src/train.py:285`` defaults fast=True):
  * fast: the Laplacian is built ONCE from the input features on the host
    (``build_hypergcn_laplacian``) and shipped as a V2V Incidence.
  * reapproximate: the reference rebuilds the Laplacian from current
    activations on CPU EVERY forward (``src/utils.py:39-41``) — an
    inherently host-side, dynamic-shape step. We reproduce it with
    ``jax.pure_callback`` into a padded static COO (SURVEY.md §7 "accept
    the perf cliff").

Layer init: W and bias ~ U(±1/sqrt(out_features)) (``src/utils.py:27-30``).
Layer widths descend in powers of two: h = [d, 2^(l-i+2)..., c]
(``src/models.py:40-46``; citeseer uses l-i+4).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import jax
import jax.numpy as jnp
import numpy as np
from allset_tpu.nn import core

from allset_tpu.graph.batch import Batch
from allset_tpu.graph.incidence import Incidence
from allset_tpu.nn.init import uniform_symmetric
from allset_tpu.ops import gather_rows, segment_sum

Array = jax.Array


def _laplacian_coo(
    num_nodes: int, edge_dict: Dict[int, List[int]], X: np.ndarray, mediators: bool, rng
):
    """(rows, cols, vals) of the symnormalized approximation adjacency."""
    rv = rng.random(X.shape[1])
    weights: Dict[tuple, float] = {}

    for members in edge_dict.values():
        members = list(members)
        k = len(members)
        if k == 0:
            continue
        p = X[members] @ rv
        Se, Ie = members[int(np.argmax(p))], members[int(np.argmin(p))]
        if mediators:
            c = 2 * k - 3 if 2 * k - 3 > 0 else 1
            for (a, b) in ((Se, Ie), (Ie, Se)):
                weights[(a, b)] = weights.get((a, b), 0.0) + 1.0 / c
            for mdt in members:
                if mdt != Se and mdt != Ie:
                    for (a, b) in ((Se, mdt), (Ie, mdt), (mdt, Se), (mdt, Ie)):
                        weights[(a, b)] = weights.get((a, b), 0.0) + 1.0 / c
        else:
            for (a, b) in ((Se, Ie), (Ie, Se)):
                weights[(a, b)] = weights.get((a, b), 0.0) + 1.0 / k

    # accumulate + unit self loops
    for v in range(num_nodes):
        weights[(v, v)] = weights.get((v, v), 0.0) + 1.0

    rows = np.fromiter((k[0] for k in weights), dtype=np.int64, count=len(weights))
    cols = np.fromiter((k[1] for k in weights), dtype=np.int64, count=len(weights))
    vals = np.fromiter(weights.values(), dtype=np.float64, count=len(weights))

    # D^{-1/2} A D^{-1/2}, D = row sums (src/utils.py:203-221)
    deg = np.zeros(num_nodes)
    np.add.at(deg, rows, vals)
    with np.errstate(divide="ignore"):
        dinv = deg ** -0.5
    dinv[~np.isfinite(dinv)] = 0.0
    vals = dinv[rows] * vals * dinv[cols]
    return rows, cols, vals.astype(np.float32)


def build_hypergcn_laplacian(
    num_nodes: int,
    edge_dict: Dict[int, List[int]],
    X: np.ndarray,
    mediators: bool = True,
    seed: int = 0,
    bucket: int = 256,
) -> Incidence:
    """Fast-path structure: built once from raw features (``src/models.py:48-50``)."""
    rng = np.random.default_rng(seed)
    rows, cols, vals = _laplacian_coo(num_nodes, edge_dict, np.asarray(X), mediators, rng)
    return Incidence.from_arrays(
        rows, cols, norm=vals, num_nodes=num_nodes, num_edges=num_nodes,
        bucket=bucket, sort_by_edge=True,
    )


def laplacian_nnz_bound(edge_dict: Dict[int, List[int]], num_nodes: int, mediators: bool) -> int:
    """Static upper bound on the approximation's nnz, for the slow path's
    padded callback output."""
    total = num_nodes  # self loops
    for members in edge_dict.values():
        k = len(members)
        total += 2 + (4 * max(k - 2, 0) if mediators else 0)
    return total


@dataclasses.dataclass(frozen=True)
class HyperGCNConfig:
    num_features: int
    num_classes: int
    all_num_layers: int = 2
    dropout: float = 0.5
    mediators: bool = True
    fast: bool = True
    dname: str = ""  # citeseer gets wider powers (src/models.py:43-44)
    dtype: str = "float32"  # 'bfloat16' -> mixed precision (fast path)

    def widths(self) -> List[int]:
        l = self.all_num_layers
        h = [self.num_features]
        for i in range(l - 1):
            power = l - i + 4 if self.dname == "citeseer" else l - i + 2
            h.append(2 ** power)
        h.append(self.num_classes)
        return h


class HyperGCNLayer(core.Module):
    out_features: int
    dtype: object = None  # jnp.bfloat16 for mixed precision

    @core.compact
    def __call__(self, x: Array, struct: Incidence) -> Array:
        std = 1.0 / np.sqrt(self.out_features)
        W = self.param("W", uniform_symmetric(std), (x.shape[-1], self.out_features))
        b = self.param("bias", uniform_symmetric(std), (self.out_features,))
        if self.dtype is not None:
            x = x.astype(self.dtype)
            W = W.astype(self.dtype)
        hw = x @ W
        if struct.node_perm is not None:
            from allset_tpu.ops.exchange import dir_spmm

            out = dir_spmm(hw, struct.v2e(), norm=struct.norm)[: struct.num_nodes]
            return out + b.astype(out.dtype)
        msg = gather_rows(hw, struct.node) * struct.norm[:, None].astype(hw.dtype)
        out = segment_sum(msg, struct.edge, struct.num_nodes, indices_are_sorted=True)
        return out + b.astype(out.dtype)


class HyperGCN(core.Module):
    """Fast-path HyperGCN: the approximation Incidence is carried in
    ``batch.extras`` as ('hypergcn_node','hypergcn_edge','hypergcn_norm')
    flattened arrays (Incidence isn't a dict entry; rebuild is cheap)."""

    cfg: HyperGCNConfig

    @core.compact
    def __call__(self, batch: Batch, train: bool = False) -> Array:
        c = self.cfg
        dt = jnp.bfloat16 if c.dtype == "bfloat16" else None
        if batch.inc is not None:
            # preferred: the full Incidence (keeps the sorted-exchange aux)
            struct = batch.inc
        else:
            ex = batch.extras
            struct = Incidence(
                node=ex["hypergcn_node"],
                edge=ex["hypergcn_edge"],
                norm=ex["hypergcn_norm"],
                mask=ex["hypergcn_mask"],
                num_nodes=batch.num_nodes,
                num_edges=batch.num_nodes,
                nnz=int(ex["hypergcn_node"].shape[0]),
            )
        h = batch.x if dt is None else batch.x.astype(dt)
        widths = c.widths()[1:]
        for i, w in enumerate(widths):
            h = jax.nn.relu(HyperGCNLayer(w, dtype=dt, name=f"layer{i}")(h, struct))
            if i < len(widths) - 1:
                h = core.Dropout(c.dropout)(h, deterministic=not train)
        return h.astype(jnp.float32)


def hypergcn_extras(struct: Incidence) -> Dict[str, Array]:
    return {
        "hypergcn_node": struct.node,
        "hypergcn_edge": struct.edge,
        "hypergcn_norm": struct.norm,
        "hypergcn_mask": struct.mask,
    }


class HyperGCNReapprox(core.Module):
    """The reference's slow path (``HyperGCN_fast=False``): the Laplacian is
    re-approximated from the CURRENT layer activations on the host every
    forward (``src/utils.py:39-41``). Reproduced with ``jax.pure_callback``
    into a statically padded COO (``laplacian_nnz_bound``); inherently a
    host-side perf cliff, kept for capability parity — the factory defaults
    to the fast path as the reference does (``src/train.py:285``).
    """

    cfg: HyperGCNConfig
    edge_dict: dict  # static: hyperedge -> member nodes
    seed: int = 0

    def _structure(self, h: Array, num_nodes: int, layer_idx: int) -> Incidence:
        bound = laplacian_nnz_bound(self.edge_dict, num_nodes, self.cfg.mediators)
        from allset_tpu.graph.incidence import pad_bucket

        npad = pad_bucket(bound, 256)

        def host_build(hw):
            rng = np.random.default_rng(self.seed + layer_idx)
            rows, cols, vals = _laplacian_coo(
                num_nodes, self.edge_dict, np.asarray(hw, np.float32),
                self.cfg.mediators, rng,
            )
            order = np.argsort(cols, kind="stable")
            rows, cols, vals = rows[order], cols[order], vals[order]
            k = len(rows)
            out_r = np.full(npad, num_nodes, np.int32)
            out_c = np.full(npad, num_nodes, np.int32)
            out_v = np.zeros(npad, np.float32)
            out_r[:k] = rows
            out_c[:k] = cols
            out_v[:k] = vals
            return out_r, out_c, out_v

        shapes = (
            jax.ShapeDtypeStruct((npad,), jnp.int32),
            jax.ShapeDtypeStruct((npad,), jnp.int32),
            jax.ShapeDtypeStruct((npad,), jnp.float32),
        )
        # vmap_method='sequential': the Trainer vmaps runs; the host rebuild
        # must execute once per run, serially.
        rows, cols, vals = jax.pure_callback(
            host_build, shapes, h, vmap_method="sequential"
        )
        return Incidence(
            node=rows, edge=cols, norm=vals,
            mask=vals != 0.0,
            num_nodes=num_nodes, num_edges=num_nodes, nnz=npad,
        )

    @core.compact
    def __call__(self, batch: Batch, train: bool = False) -> Array:
        c = self.cfg
        h = batch.x
        n = batch.num_nodes
        widths = c.widths()[1:]
        for i, w in enumerate(widths):
            std = 1.0 / np.sqrt(w)
            W = self.param(f"W{i}", uniform_symmetric(std), (h.shape[-1], w))
            b = self.param(f"bias{i}", uniform_symmetric(std), (w,))
            hw = h @ W
            struct = self._structure(
                jax.lax.stop_gradient(hw), n, i
            )  # host reapprox from activations
            msg = gather_rows(hw, struct.node) * struct.norm[:, None]
            h = segment_sum(msg, struct.edge, n, indices_are_sorted=True) + b
            h = jax.nn.relu(h)
            if i < len(widths) - 1:
                h = core.Dropout(c.dropout)(h, deterministic=not train)
        return h
