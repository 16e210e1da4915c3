"""Heterogeneous-graph HAN: the analog of the reference's cached-metapath
variant (``src/DGL_HAN/model_hetero.py:40-117``).

The reference model takes the ORIGINAL heterogeneous graph plus a list of
metapaths and, on first forward, derives one homogeneous graph per
metapath with ``dgl.metapath_reachable_graph`` (cached on the graph
object); each layer then runs one GAT per metapath and fuses them with
semantic attention.

Host/device split: graph derivation is inherently host-side, dynamic-shape
preprocessing — it runs ONCE per graph in numpy/scipy (SpGEMM composition
of the edge-type adjacencies, binarized reachability) and is cached with
the reference's own semantics (keyed on the graph object identity,
``model_hetero.py:76-84``). The derived static-shape incidences then feed
a jit-compiled module (GAT-per-metapath + semantic attention, shared
with models/han.py).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
import scipy.sparse as sp
from allset_tpu.nn import core

from allset_tpu.graph.incidence import Incidence

Array = jax.Array


@dataclasses.dataclass(frozen=True)
class HeteroGraph:
    """A typed graph: per-type node counts and per-edge-type COO arrays.

    ``edges`` maps canonical edge types ``(src_type, relation, dst_type)``
    to ``(src_ids, dst_ids)`` numpy arrays — the dgl heterograph surface
    the reference's HAN consumes (``model_hetero.py:103-117``)."""

    num_nodes: Dict[str, int]
    edges: Dict[Tuple[str, str, str], Tuple[np.ndarray, np.ndarray]]

    def adj(self, etype: Tuple[str, str, str]) -> sp.csr_matrix:
        s, _, d = etype
        src, dst = self.edges[etype]
        return sp.csr_matrix(
            (np.ones(len(src), np.float32), (src, dst)),
            shape=(self.num_nodes[s], self.num_nodes[d]),
        )

    def etype_by_relation(self, relation: str) -> Tuple[str, str, str]:
        hits = [e for e in self.edges if e[1] == relation]
        if len(hits) != 1:
            raise KeyError(f"relation {relation!r} matches {len(hits)} edge types")
        return hits[0]


def metapath_reachable(
    g: HeteroGraph, metapath: Sequence[str], bucket: int = 256
) -> Incidence:
    """``dgl.metapath_reachable_graph`` semantics: compose the edge-type
    adjacencies along ``metapath`` (relation names), binarize reachability,
    and return the homogeneous graph over the endpoint node type as an
    Incidence (node=src, edge=dst — DGLGATConv aggregates g.node rows
    into g.edge segments)."""
    etypes = [g.etype_by_relation(r) for r in metapath]
    for a, b in zip(etypes, etypes[1:]):
        if a[2] != b[0]:
            raise ValueError(f"metapath breaks between {a} and {b}")
    acc = g.adj(etypes[0])
    for e in etypes[1:]:
        acc = acc @ g.adj(e)
    acc = (acc != 0).tocoo()  # reachability, not path counts
    n_dst = g.num_nodes[etypes[-1][2]]
    n_src = g.num_nodes[etypes[0][0]]
    if n_dst != n_src:
        raise ValueError("metapath must start and end on the same node type")
    return Incidence.from_arrays(
        np.asarray(acc.row, np.int64),
        np.asarray(acc.col, np.int64),
        norm=np.ones(acc.nnz, np.float32),
        num_nodes=n_dst,
        num_edges=n_src,
        bucket=bucket,
    )


@dataclasses.dataclass(frozen=True)
class HeteroHANConfig:
    num_features: int
    num_classes: int
    hidden_units: int = 8
    num_heads: Tuple[int, ...] = (8,)
    dropout: float = 0.6


class MetapathHAN(core.Module):
    """HAN over P precomputed metapath graphs: one DGLGATConv per metapath
    per layer, semantic attention across metapaths, linear predict head
    (reference ``model_hetero.py:40-117``; generalizes models/han.py's
    fixed VEV/EVE pair to any metapath list)."""

    cfg: HeteroHANConfig
    num_paths: int

    @core.compact
    def __call__(
        self, graphs: List[Incidence], x: Array, train: bool = False
    ) -> Array:
        from allset_tpu.models.han import (  # local: avoid a module cycle
            DGLGATConv, SemanticAttention,
        )
        from allset_tpu.nn.modules import TorchDense

        assert len(graphs) == self.num_paths
        c = self.cfg
        h = x
        for li, heads in enumerate(c.num_heads):
            embeds = [
                DGLGATConv(
                    out_channels=c.hidden_units,
                    heads=heads,
                    feat_drop=c.dropout,
                    attn_drop=c.dropout,
                    name=f"gat_l{li}_p{gi}",
                )(g, h, train)
                for gi, g in enumerate(graphs)
            ]
            z = jnp.stack(embeds, axis=1)  # [N, P, D*K]
            h = SemanticAttention(name=f"sem_l{li}")(z)
        return TorchDense(c.num_classes, name="predict")(h)


class HeteroHAN:
    """The reference's hetero HAN surface: construct with metapaths, call
    with the ORIGINAL heterogeneous graph — per-metapath reachable graphs
    derive lazily on first use and cache on graph identity, exactly like
    ``model_hetero.py:70-84``'s ``_cached_coalesced_graph``."""

    def __init__(
        self,
        cfg: HeteroHANConfig,
        meta_paths: Sequence[Sequence[str]],
        bucket: int = 256,
    ):
        self.cfg = cfg
        self.meta_paths = [tuple(mp) for mp in meta_paths]
        self.bucket = bucket
        self.module = MetapathHAN(cfg, num_paths=len(self.meta_paths))
        self._cached_graph = None
        self._cached_coalesced: Dict[Tuple[str, ...], Incidence] = {}

    def coalesced(self, g: HeteroGraph) -> List[Incidence]:
        if self._cached_graph is None or self._cached_graph is not g:
            self._cached_graph = g
            self._cached_coalesced.clear()
            for mp in self.meta_paths:
                self._cached_coalesced[mp] = metapath_reachable(
                    g, mp, bucket=self.bucket
                )
        return [self._cached_coalesced[mp] for mp in self.meta_paths]

    def init(self, rngs, g: HeteroGraph, x: Array, train: bool = False):
        return self.module.init(rngs, self.coalesced(g), x, train)

    def apply(self, variables, g: HeteroGraph, x: Array,
              train: bool = False, **kw):
        return self.module.apply(variables, self.coalesced(g), x, train, **kw)
