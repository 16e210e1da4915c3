"""HAN: Heterogeneous Graph Attention Network over metapath graphs.

Reference ``src/DGL_HAN/model.py``: one DGL-style GAT per metapath graph +
semantic attention softmax over the per-metapath embeddings, stacked, then
a linear predictor. Our metapath graphs (VEV, EVE) come from
``allset_tpu.graph.metapath.build_metapath_graphs`` (scipy SpGEMM, as the
reference exporter does at ``DGL_HAN/print_dataset_statistics.py:129-137``).

DGL GATConv semantics reproduced: feat-dropout on inputs, attention
dropout on the softmaxed alphas, leaky_relu(0.2) scores, ELU activation,
xavier-normal(gain=sqrt(2)) init, heads concatenated.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from allset_tpu.nn import core

from allset_tpu.graph.batch import Batch
from allset_tpu.graph.incidence import Incidence
from allset_tpu.nn.modules import TorchDense, _head_expand
from allset_tpu.ops import gather_rows, segment_softmax, segment_sum

Array = jax.Array


def xavier_normal_gain(gain: float):
    def init(key, shape, dtype=jnp.float32):
        fan_in, fan_out = shape[0], shape[-1]
        if len(shape) == 3:  # (1, H, C) attention vectors: torch fans
            fan_in, fan_out = shape[1] * shape[2], shape[2]
        std = gain * np.sqrt(2.0 / (fan_in + fan_out))
        return std * jax.random.normal(key, shape, dtype)

    return init


class DGLGATConv(core.Module):
    """DGL-style GATConv over an Incidence-as-graph (src=node, dst=edge
    both in the combined id space)."""

    out_channels: int
    heads: int
    feat_drop: float = 0.0
    attn_drop: float = 0.0
    negative_slope: float = 0.2
    use_elu: bool = True

    @core.compact
    def __call__(self, g: Incidence, x: Array, train: bool = False) -> Array:
        H, C = self.heads, self.out_channels
        HC = H * C
        x = core.Dropout(self.feat_drop)(x, deterministic=not train)
        w = self.param("fc", xavier_normal_gain(np.sqrt(2.0)), (x.shape[-1], HC))
        attn_l = self.param("attn_l", xavier_normal_gain(np.sqrt(2.0)), (1, H, C))
        attn_r = self.param("attn_r", xavier_normal_gain(np.sqrt(2.0)), (1, H, C))

        if g.node_perm is not None:
            # PMA-style packed path (r5): the el/er score projections fold
            # into the feature GEMM as block one-hot column blocks, the
            # softmax uses a GLOBAL per-head shift — exact by shift
            # invariance: leaky_relu is monotone, so leaky(colmax(el) +
            # colmax(er)) upper-bounds every score (the PMA 'global' mode
            # argument) — and ONE packed [h*e | e] sorted reduce replaces
            # the narrow [nnz, H] segment max/sum chain. Math matches the
            # reference path below.
            from allset_tpu.ops.exchange import dir_gather, dir_reduce

            d = g.v2e()
            blk = (
                jax.lax.broadcasted_iota(jnp.int32, (HC, H), 0) // C
                == jax.lax.broadcasted_iota(jnp.int32, (HC, H), 1)
            )
            Pl = jnp.where(blk, attn_l.reshape(HC)[:, None], 0.0)
            Pr = jnp.where(blk, attn_r.reshape(HC)[:, None], 0.0)
            Wf = jnp.concatenate([w, w @ Pl, w @ Pr], axis=1)
            yf = x @ Wf  # ONE GEMM: [values | el | er]
            h = yf[:, :HC]
            el = yf[:, HC : HC + H].astype(jnp.float32)
            er = yf[:, HC + H :].astype(jnp.float32)
            gmax = jax.lax.stop_gradient(
                jax.nn.leaky_relu(
                    jnp.max(el, axis=0) + jnp.max(er, axis=0),
                    self.negative_slope,
                )
            )
            gmax = jnp.maximum(gmax, 0.0)  # empty-table guard
            packed = jnp.concatenate([h, el.astype(h.dtype)], axis=1)
            pj = dir_gather(packed, d)  # [nnz, HC+H]
            er_j = jnp.take(er, d.dst, axis=0, mode="clip")
            s = jax.nn.leaky_relu(
                pj[:, HC:].astype(jnp.float32) + er_j, self.negative_slope
            )
            e = jnp.exp(s - gmax[None, :])
            # DGL drops the NORMALIZED alphas; mask*e/den == mask*(e/den),
            # so dropout rides the numerator while the denominator stays
            # undropped (same bernoulli shape as the reference's alpha)
            e_num = core.Dropout(self.attn_drop)(e, deterministic=not train)
            parts = [
                pj[:, :HC] * jnp.repeat(e_num.astype(h.dtype), C, axis=1),
                e.astype(h.dtype),
            ]
            agg = dir_reduce(jnp.concatenate(parts, axis=1), d, "add")
            den = jnp.maximum(agg[:, HC : HC + H].astype(jnp.float32), 1e-16)
            out = (agg[:, :HC].astype(jnp.float32)
                   / jnp.repeat(den, C, axis=1)).astype(h.dtype)
        else:
            h = x @ w  # flat [T, H*C]
            el = (h.reshape(-1, H, C) * attn_l).sum(-1)  # [T, H]
            er = (h.reshape(-1, H, C) * attn_r).sum(-1)
            alpha = gather_rows(el, g.node) + gather_rows(er, g.edge)
            alpha = jax.nn.leaky_relu(alpha, self.negative_slope)
            alpha = segment_softmax(
                alpha, g.edge, g.num_edges, mask=g.mask,
                indices_are_sorted=False,
            )
            alpha = core.Dropout(self.attn_drop)(alpha, deterministic=not train)
            msg = gather_rows(h, g.node) * _head_expand(alpha, C)
            out = segment_sum(msg, g.edge, g.num_edges)
        if self.use_elu:
            out = jax.nn.elu(out)
        return out  # [T, H*C]


class SemanticAttention(core.Module):
    """softmax over metapaths of a projected mean score
    (``DGL_HAN/model.py:7-22``)."""

    hidden_size: int = 128

    @core.compact
    def __call__(self, z: Array) -> Array:
        # z: [T, P, D]
        w = TorchDense(self.hidden_size, name="proj1")(z)
        w = jnp.tanh(w)
        w = TorchDense(1, use_bias=False, name="proj2")(w)  # [T, P, 1]
        beta = jax.nn.softmax(w.mean(axis=0), axis=0)  # [P, 1]
        return (beta[None] * z).sum(axis=1)  # [T, D]


@dataclasses.dataclass(frozen=True)
class HANConfig:
    num_features: int
    num_classes: int
    hidden_units: int = 8
    num_heads: Tuple[int, ...] = (8,)
    dropout: float = 0.6


class HAN(core.Module):
    cfg: HANConfig

    @core.compact
    def __call__(self, batch: Batch, train: bool = False) -> Array:
        """batch.extras carries the VEV/EVE metapath graphs — as full
        Incidence pytrees (``han_extras`` keeps the sorted-order aux
        so DGLGATConv's packed path engages; the flat legacy keys are
        still accepted for old callers, at slow-path cost)."""
        c = self.cfg
        graphs = []
        for name in ("vev", "eve"):
            if name in batch.extras:
                graphs.append(batch.extras[name])
                continue
            graphs.append(
                Incidence(
                    node=batch.extras[f"{name}_node"],
                    edge=batch.extras[f"{name}_edge"],
                    norm=batch.extras[f"{name}_norm"],
                    mask=batch.extras[f"{name}_mask"],
                    num_nodes=batch.num_nodes,
                    num_edges=batch.num_nodes,
                    nnz=int(batch.extras[f"{name}_node"].shape[0]),
                )
            )
        h = batch.x
        for li, heads in enumerate(c.num_heads):
            embeds = []
            for gi, g in enumerate(graphs):
                embeds.append(
                    DGLGATConv(
                        out_channels=c.hidden_units,
                        heads=heads,
                        feat_drop=c.dropout,
                        attn_drop=c.dropout,
                        name=f"gat_l{li}_p{gi}",
                    )(g, h, train)
                )
            z = jnp.stack(embeds, axis=1)  # [T, P, D*K]
            h = SemanticAttention(name=f"sem_l{li}")(z)
        return TorchDense(c.num_classes, name="predict")(h)


class BlockGATConv(core.Module):
    """GAT over a sampled block: each seed attends over its fixed-size
    [K+1] neighbor set — the dense, regular-shape form of DGL's
    block-GATConv used by the sampled trainer
    (``DGL_HAN/train_sampling.py:28-90``)."""

    out_channels: int
    heads: int
    feat_drop: float = 0.0
    attn_drop: float = 0.0
    negative_slope: float = 0.2

    @core.compact
    def __call__(self, h_src: Array, h_dst: Array, mask: Array, train: bool = False) -> Array:
        # h_src: [B, K1, F], h_dst: [B, F], mask: [B, K1]
        H, C = self.heads, self.out_channels
        h_src = core.Dropout(self.feat_drop)(h_src, deterministic=not train)
        h_dst = core.Dropout(self.feat_drop)(h_dst, deterministic=not train)
        w = self.param("fc", xavier_normal_gain(np.sqrt(2.0)), (h_src.shape[-1], H * C))
        attn_l = self.param("attn_l", xavier_normal_gain(np.sqrt(2.0)), (1, H, C))
        attn_r = self.param("attn_r", xavier_normal_gain(np.sqrt(2.0)), (1, H, C))

        zs = h_src @ w  # [B, K1, H*C]
        zd = h_dst @ w  # [B, H*C]
        B, K1 = zs.shape[0], zs.shape[1]
        el = (zs.reshape(B, K1, H, C) * attn_l[None]).sum(-1)  # [B, K1, H]
        er = (zd.reshape(B, H, C) * attn_r).sum(-1)  # [B, H]
        scores = jax.nn.leaky_relu(el + er[:, None, :], self.negative_slope)
        scores = jnp.where(mask[..., None], scores, -1e30)
        alpha = jax.nn.softmax(scores, axis=1)
        alpha = jnp.where(mask[..., None], alpha, 0.0)
        alpha = core.Dropout(self.attn_drop)(alpha, deterministic=not train)
        out = jnp.einsum("bkh,bkhc->bhc", alpha, zs.reshape(B, K1, H, C))
        return jax.nn.elu(out.reshape(B, H * C))


class SampledHAN(core.Module):
    """Mini-batch HAN over sampled blocks (``DGL_HAN/train_sampling.py``):
    per metapath a BlockGATConv, then semantic attention, then predict.
    Inputs are the per-block gathered features (device-side gather from
    the full table replaces the reference's host-side load_subtensors)."""

    cfg: HANConfig

    @core.compact
    def __call__(self, x_full: Array, seeds: Array, blocks: dict, train: bool = False) -> Array:
        c = self.cfg
        h_dst = jnp.take(x_full, seeds, axis=0, mode="clip")
        embeds = []
        for gi, name in enumerate(("vev", "eve")):
            src = blocks[f"{name}_src"]  # [B, K1]
            mask = blocks[f"{name}_mask"]
            h_src = jnp.take(x_full, src.reshape(-1), axis=0, mode="clip").reshape(
                src.shape + (x_full.shape[-1],)
            )
            embeds.append(
                BlockGATConv(
                    out_channels=c.hidden_units,
                    heads=c.num_heads[0],
                    feat_drop=c.dropout,
                    attn_drop=c.dropout,
                    name=f"gat_p{gi}",
                )(h_src, h_dst, mask, train)
            )
        z = jnp.stack(embeds, axis=1)  # [B, P, D*K]
        h = SemanticAttention(name="sem")(z)
        return TorchDense(c.num_classes, name="predict")(h)


def han_extras(vev: Incidence, eve: Incidence) -> dict:
    """Full Incidence pytrees: keeps the sorted-order aux
    so the GAT conv's packed sorted path engages."""
    return {"vev": vev, "eve": eve}
