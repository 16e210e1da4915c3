"""Clique-expansion baselines: CEGCN / CEGAT.

Reference ``src/models.py:80-183``: hyperedges are expanded into weighted
node-node pairs (``ConstructV2V``, ``src/preprocessing.py:343-391``;
``allset_tpu.graph.transforms.construct_v2v``), then stock graph convs run
on the resulting (directed, i<j) V2V graph. The V2V graph is carried as an
Incidence whose 'edge' space is the node space (num_edges == num_nodes).

GCNConv follows PyG's GCNConv(normalize=False): X' = A_norm (X W) + b with
A_norm precomputed by gcn_norm. GATConv follows PyG 1.6.x GATConv:
per-head scores att_l . x_src + att_r . x_dst, leaky_relu, softmax over
incoming edges at the destination, heads concat except on the output
layer. Self-loops for GAT are added host-side at preprocessing (PyG adds
them at call time; static shapes demand preprocessing).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
from allset_tpu.nn import core

from allset_tpu.graph.batch import Batch
from allset_tpu.nn.init import glorot_uniform, xavier_uniform_torch_fans
from allset_tpu.nn.modules import _head_expand
from allset_tpu.ops import gather_rows, segment_softmax, segment_sum

Array = jax.Array


class GCNConv(core.Module):
    """PyG GCNConv(normalize=False): out = scatter(norm * (XW)[src] -> dst) + b."""

    out_channels: int
    dtype: object = None  # jnp.bfloat16 for mixed precision

    @core.compact
    def __call__(self, x: Array, batch: Batch) -> Array:
        g = batch.inc  # V2V graph: node=src, edge=dst, norm=weights
        weight = self.param("weight", glorot_uniform(), (x.shape[-1], self.out_channels))
        bias = self.param("bias", jax.nn.initializers.zeros, (self.out_channels,))
        if self.dtype is not None:
            x = x.astype(self.dtype)
            weight = weight.astype(self.dtype)
        h = x @ weight
        if g.node_perm is not None:
            from allset_tpu.ops.exchange import dir_spmm

            out = dir_spmm(h, g.v2e(), norm=g.norm)[: g.num_nodes]
        else:
            msg = gather_rows(h, g.node) * g.norm[:, None].astype(h.dtype)
            out = segment_sum(msg, g.edge, g.num_nodes)
        return out + bias.astype(out.dtype)


class GATConv(core.Module):
    out_channels: int
    heads: int = 1
    dtype: object = None
    concat: bool = True
    negative_slope: float = 0.2
    dropout: float = 0.6

    @core.compact
    def __call__(self, x: Array, batch: Batch, train: bool = False) -> Array:
        g = batch.inc
        H, C = self.heads, self.out_channels
        weight = self.param("weight", glorot_uniform(), (x.shape[-1], H * C))
        att_l = self.param("att_l", xavier_uniform_torch_fans((1, H, C)), (1, H, C))
        att_r = self.param("att_r", xavier_uniform_torch_fans((1, H, C)), (1, H, C))

        if self.dtype is not None:
            x = x.astype(self.dtype)
            weight = weight.astype(self.dtype)
        h = x @ weight  # flat [N, H*C]
        a_src = (h.reshape(-1, H, C) * att_l).sum(-1).astype(jnp.float32)  # [N, H]
        a_dst = (h.reshape(-1, H, C) * att_r).sum(-1).astype(jnp.float32)
        alpha = gather_rows(a_src, g.node) + gather_rows(a_dst, g.edge)
        alpha = jax.nn.leaky_relu(alpha, self.negative_slope)
        alpha = segment_softmax(
            alpha, g.edge, g.num_nodes, mask=g.mask,
            indices_are_sorted=g.node_perm is not None,
        )
        alpha = core.Dropout(self.dropout)(alpha, deterministic=not train)
        if g.node_perm is not None:
            from allset_tpu.ops.exchange import dir_gather, dir_reduce

            d = g.v2e()
            msg = dir_gather(h, d) * _head_expand(alpha.astype(h.dtype), C)
            out = dir_reduce(msg, d, "add")[: g.num_nodes].astype(h.dtype)
        else:
            msg = gather_rows(h, g.node) * _head_expand(alpha, C)
            out = segment_sum(msg, g.edge, g.num_nodes)
        if not self.concat:
            out = out.reshape(-1, H, C).mean(axis=1)
        bias = self.param(
            "bias", jax.nn.initializers.zeros, (H * C if self.concat else C,)
        )
        return out + bias.astype(out.dtype)


@dataclasses.dataclass(frozen=True)
class CEConfig:
    num_features: int
    num_classes: int
    all_num_layers: int = 2
    mlp_hidden: int = 64
    dropout: float = 0.5
    normalization: str = "None"  # 'bn' or anything-else->Identity (ref default)
    heads: int = 1
    output_heads: int = 1
    dtype: str = "float32"  # 'bfloat16' -> mixed precision


def _dt(cfg):
    return jnp.bfloat16 if cfg.dtype == "bfloat16" else None


class CEGCN(core.Module):
    """GCN stack on the clique expansion (``src/models.py:80-128``)."""

    cfg: CEConfig

    @core.compact
    def __call__(self, batch: Batch, train: bool = False) -> Array:
        c = self.cfg
        x = batch.x
        widths = [c.mlp_hidden] * (c.all_num_layers - 1) + [c.num_classes]
        for i, w in enumerate(widths):
            x = GCNConv(w, dtype=_dt(c), name=f"conv{i}")(x, batch)
            if i < len(widths) - 1:
                x = jax.nn.relu(x)
                if c.normalization == "bn":
                    x = core.BatchNorm(use_running_average=not train, momentum=0.9,
                                     epsilon=1e-5, name=f"bn{i}")(x)
                x = core.Dropout(c.dropout)(x, deterministic=not train)
        return x.astype(jnp.float32)


class CEGAT(core.Module):
    """GAT stack on the clique expansion (``src/models.py:131-183``)."""

    cfg: CEConfig

    @core.compact
    def __call__(self, batch: Batch, train: bool = False) -> Array:
        c = self.cfg
        x = batch.x
        for i in range(c.all_num_layers - 1):
            x = GATConv(c.mlp_hidden, heads=c.heads, concat=True, dtype=_dt(c), name=f"conv{i}")(
                x, batch, train
            )
            x = jax.nn.relu(x)
            if c.normalization == "bn":
                x = core.BatchNorm(use_running_average=not train, momentum=0.9,
                                 epsilon=1e-5, name=f"bn{i}")(x)
            x = core.Dropout(c.dropout)(x, deterministic=not train)
        x = GATConv(
            c.num_classes, heads=c.output_heads, concat=False, dtype=_dt(c),
            name=f"conv{c.all_num_layers - 1}",
        )(x, batch, train)
        return x.astype(jnp.float32)
