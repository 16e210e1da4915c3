"""UniGNN family + UniGCNII.

Reference ``src/models.py:580-996`` (adapted there from the official
UniGNN repo). All convs share the two-stage gather/scatter idiom

    Xve = X[vertex]; Xe = scatter(Xve, edges, reduce=first_aggregate)
    Xev = Xe[edges]; Xv = scatter(Xev, vertex, reduce=second)

over the incidence arrays (vertex == inc.node, edges == inc.edge). Only
UniGCNII is reachable from the reference factory (``src/train.py:92-101``);
the rest are kept for capability parity. Degree vectors degV^{-1/2},
degE^{-1/2} come from ``allset_tpu.graph.transforms.unignn_degrees``
(reference ``src/train.py:396-412``) via ``batch.extras``.
"""

from __future__ import annotations

import dataclasses
import math

import jax
import jax.numpy as jnp
from allset_tpu.nn import core

from allset_tpu.graph.batch import Batch
from allset_tpu.nn.init import xavier_uniform_torch_fans
from allset_tpu.nn.modules import TorchDense, _head_expand
from allset_tpu.ops import gather_rows, segment_reduce, segment_softmax, segment_sum

Array = jax.Array


def normalize_l2(x: Array) -> Array:
    """Row-normalize (``src/models.py:590-596``); zero rows stay zero."""
    norm = jnp.linalg.norm(x, axis=1, keepdims=True)
    scale = jnp.where(norm > 0, 1.0 / norm, 0.0)
    return x * scale


def _two_stage(x, batch, first_aggregate, second_aggregate="sum", scale_e=None, scale_v=None):
    """The UniGNN gather/scatter idiom (``src/models.py:627-632``), routed
    through the sorted-everywhere exchange (sorted reduces + permute-free
    backward) whenever the incidence carries the aux, and through the
    explicit shard_map edge-partitioned exchange (parallel/sharded.py)
    when ``batch.shex`` is set with an UNSPLIT build (sl_mode 'none' —
    UniGNN treats every incidence entry uniformly, so the self-loop-split
    layout does not apply).

    The V2E mean divisor and UniGCNII's degE scaling fold into one [M, F]
    pass (measured r3 NEGATIVE result: folding them further, into a
    per-entry E2V exchange norm ``w[i] = se[src_i] * sv[dst_i]``, LOSES
    ~10% at bench scale — the two narrow [nnz] scalar-gather norm builds,
    the per-pass [nnz, F] multiply, and the backward's extra [nnz] norm
    permute-gather cost more than the [M, F] + [N, F] row-space passes
    they replace; row-space scaling is the cheaper side of the
    exchange)."""
    inc = batch.inc
    shex = getattr(batch, "shex", None)
    if shex is not None and shex.v2e.sl_mode != "none":
        shex = None  # split build: semantics don't apply, use GSPMD path
    agg1 = {"sum": "add"}.get(first_aggregate, first_aggregate)
    agg2 = {"sum": "add"}.get(second_aggregate, second_aggregate)
    if shex is not None or inc.node_perm is not None:
        from allset_tpu.ops.exchange import dir_spmm

        if agg1 == "mean" and scale_e is not None and inc.edge_count is not None:
            # fold the mean divisor into the static edge scaling: one
            # [M, F] pass (scale_e / count) instead of two (mean's
            # divide, then scale_e) — UniGCNII runs this per conv layer
            cnt = jnp.maximum(inc.edge_count, 1.0)
            scale_e = (scale_e.reshape(-1) / cnt)[:, None].astype(scale_e.dtype)
            agg1 = "add"
        dv = shex.v2e if shex is not None else inc.v2e()
        de = shex.e2v if shex is not None else inc.e2v()
        xe = dir_spmm(x, dv, reduce=agg1)
        if scale_e is not None:
            xe = xe * scale_e.astype(xe.dtype)
        xv = dir_spmm(xe, de, reduce=agg2)
    else:
        xve = gather_rows(x, inc.node)
        xe = segment_reduce(xve, inc.edge, inc.num_edges, first_aggregate, indices_are_sorted=True)
        if scale_e is not None:
            xe = xe * scale_e.astype(xe.dtype)
        xev = gather_rows(xe, inc.edge)
        xv = segment_reduce(xev, inc.node, inc.num_nodes, second_aggregate)
    if scale_v is not None:
        xv = xv * scale_v.astype(xv.dtype)
    return xv, xe


@dataclasses.dataclass(frozen=True)
class UniGNNConfig:
    num_features: int
    num_classes: int
    model_name: str = "UniGCN"  # UniGAT | UniGCN | UniGCN2 | UniGIN | UniSAGE
    all_num_layers: int = 2
    mlp_hidden: int = 8
    heads: int = 8
    dropout: float = 0.6
    input_drop: float = 0.6
    attn_drop: float = 0.6
    first_aggregate: str = "mean"
    second_aggregate: str = "sum"
    use_norm: bool = False
    activation: str = "relu"
    dtype: str = "float32"  # 'bfloat16' -> mixed precision


def _dt(cfg):
    return jnp.bfloat16 if cfg.dtype == "bfloat16" else None


class UniSAGEConv(core.Module):
    cfg: UniGNNConfig
    out_channels: int
    heads: int = 1

    @core.compact
    def __call__(self, x: Array, batch: Batch, train: bool = False) -> Array:
        c = self.cfg
        x = TorchDense(self.heads * self.out_channels, use_bias=False, dtype=_dt(c), name="W")(x)
        xv, _ = _two_stage(x, batch, c.first_aggregate, c.second_aggregate)
        x = x + xv
        return normalize_l2(x) if c.use_norm else x


class UniGINConv(core.Module):
    cfg: UniGNNConfig
    out_channels: int
    heads: int = 1

    @core.compact
    def __call__(self, x: Array, batch: Batch, train: bool = False) -> Array:
        c = self.cfg
        eps = self.param("eps", jax.nn.initializers.zeros, (1,))
        x = TorchDense(self.heads * self.out_channels, use_bias=False, dtype=_dt(c), name="W")(x)
        xv, _ = _two_stage(x, batch, c.first_aggregate, "sum")
        x = (1 + eps) * x + xv
        return normalize_l2(x) if c.use_norm else x


class UniGCNConv(core.Module):
    cfg: UniGNNConfig
    out_channels: int
    heads: int = 1

    @core.compact
    def __call__(self, x: Array, batch: Batch, train: bool = False) -> Array:
        c = self.cfg
        degV, degE = batch.extras["degV"], batch.extras["degE"]
        x = TorchDense(self.heads * self.out_channels, use_bias=False, dtype=_dt(c), name="W")(x)
        xv, _ = _two_stage(x, batch, c.first_aggregate, "sum",
                           scale_e=degE, scale_v=degV)
        return normalize_l2(xv) if c.use_norm else xv


class UniGCNConv2(core.Module):
    """v2: X -> AX -> norm -> AXW (``src/models.py:742-788``)."""

    cfg: UniGNNConfig
    out_channels: int
    heads: int = 1

    @core.compact
    def __call__(self, x: Array, batch: Batch, train: bool = False) -> Array:
        c = self.cfg
        degV, degE = batch.extras["degV"], batch.extras["degE"]
        xv, _ = _two_stage(x, batch, c.first_aggregate, "sum",
                           scale_e=degE, scale_v=degV)
        if c.use_norm:
            xv = normalize_l2(xv)
        return TorchDense(self.heads * self.out_channels, use_bias=True, dtype=_dt(c), name="W")(xv)


class UniGATConv(core.Module):
    cfg: UniGNNConfig
    out_channels: int
    heads: int = 1
    negative_slope: float = 0.2
    skip_sum: bool = False

    @core.compact
    def __call__(self, x: Array, batch: Batch, train: bool = False) -> Array:
        c = self.cfg
        inc = batch.inc
        H, C = self.heads, self.out_channels
        x0 = TorchDense(H * C, use_bias=False, dtype=_dt(c), name="W")(x)

        # flat [rows, H*C] layout throughout
        xve = gather_rows(x0, inc.node)
        xe = segment_reduce(xve, inc.edge, inc.num_edges, c.first_aggregate,
                            indices_are_sorted=True)  # [E, H*C]
        att_e = self.param("att_e", xavier_uniform_torch_fans((1, H, C)), (1, H, C))
        alpha_e = (xe.reshape(-1, H, C) * att_e).sum(-1)  # [E,H]
        a_ev = gather_rows(alpha_e, inc.edge)
        alpha = jax.nn.leaky_relu(a_ev, self.negative_slope)
        alpha = segment_softmax(alpha, inc.node, inc.num_nodes, mask=inc.mask)
        alpha = core.Dropout(c.attn_drop)(alpha, deterministic=not train)

        xev = gather_rows(xe, inc.edge) * _head_expand(alpha.astype(xe.dtype), C)
        out = segment_sum(xev, inc.node, inc.num_nodes)
        if c.use_norm:
            out = normalize_l2(out)
        if self.skip_sum:
            out = out + x0
        return out


_CONVS = {
    "UniGAT": UniGATConv,
    "UniGCN": UniGCNConv,
    "UniGCN2": UniGCNConv2,
    "UniGIN": UniGINConv,
    "UniSAGE": UniSAGEConv,
}


class UniGNN(core.Module):
    """Generic UniGNN stack (``src/models.py:869-907``). Note the reference
    returns log_softmax from forward; our trainer applies log_softmax in
    the loss, so logits are returned here (same training math)."""

    cfg: UniGNNConfig

    @core.compact
    def __call__(self, batch: Batch, train: bool = False) -> Array:
        c = self.cfg
        Conv = _CONVS[c.model_name]
        act = jax.nn.relu if c.activation == "relu" else core.PReLU()
        x = core.Dropout(c.input_drop)(batch.x, deterministic=not train)
        for i in range(c.all_num_layers - 1):
            x = Conv(c, c.mlp_hidden, heads=c.heads, name=f"conv{i}")(x, batch, train)
            x = act(x)
            x = core.Dropout(c.dropout)(x, deterministic=not train)
        x = Conv(c, c.num_classes, heads=1, name="conv_out")(x, batch, train)
        return x.astype(jnp.float32)


class UniGCNIIConv(core.Module):
    """GCNII-style identity-mapped conv (``src/models.py:911-944``)."""

    cfg: "UniGCNIIConfig"
    out_features: int

    @core.compact
    def __call__(self, x, x0, alpha, beta, batch: Batch) -> Array:
        degV, degE = batch.extras["degV"], batch.extras["degE"]
        xv, _ = _two_stage(x, batch, "mean", "sum", scale_e=degE, scale_v=degV)
        if self.cfg.use_norm:
            xv = normalize_l2(xv)
        xi = (1 - alpha) * xv + alpha * x0.astype(xv.dtype)
        w = TorchDense(self.out_features, use_bias=False, dtype=_dt(self.cfg), name="W")
        return (1 - beta) * xi + beta * w(xi)


@dataclasses.dataclass(frozen=True)
class UniGCNIIConfig:
    num_features: int
    num_classes: int
    all_num_layers: int = 2
    mlp_hidden: int = 64
    heads: int = 1
    use_norm: bool = False
    dtype: str = "float32"  # 'bfloat16' -> mixed precision


class UniGCNII(core.Module):
    """UniGCNII (``src/models.py:948-996``): input linear, nlayer identity-
    mapping convs with beta = log(lamda/(i+1)+1), output linear; dropout
    0.2, lamda=0.5, alpha=0.1 hard-coded as in the reference."""

    cfg: UniGCNIIConfig

    @core.compact
    def __call__(self, batch: Batch, train: bool = False) -> Array:
        c = self.cfg
        nhid = c.mlp_hidden * c.heads
        drop = core.Dropout(0.2)
        lamda, alpha = 0.5, 0.1

        x = drop(batch.x, deterministic=not train)
        x = jax.nn.relu(TorchDense(nhid, dtype=_dt(c), name="lin_in")(x))
        x0 = x
        for i in range(c.all_num_layers):
            x = drop(x, deterministic=not train)
            beta = math.log(lamda / (i + 1) + 1)
            x = jax.nn.relu(
                UniGCNIIConv(c, nhid, name=f"conv{i}")(x, x0, alpha, beta, batch)
            )
        x = drop(x, deterministic=not train)
        return TorchDense(c.num_classes, dtype=_dt(c), name="lin_out")(x).astype(jnp.float32)
