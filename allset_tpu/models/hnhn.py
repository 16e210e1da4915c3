"""HNHN: Hypergraph Networks with Hyperedge Neurons.

Reference ``src/layers.py:233-315`` (HNHNConv) and ``src/models.py:207-249``
(HNHN wrapper). One conv is:

    E  = D_e_beta_inv * segsum_e( (D_v_beta * (X W_v2e))[v] )   V->E
    E  = relu(E)                 (nonlinear_inbetween)
    X' = D_v_alpha_inv * segsum_v( (D_e_alpha * (E W_e2v))[e] ) E->V

with the four degree-powered vectors precomputed on the host by
``allset_tpu.graph.transforms.generate_norm_hnhn`` (reference
``src/preprocessing.py:295-340``; alpha=-1.5, beta=-0.5 defaults from
``src/train.py:269-270``) and carried in ``batch.extras``.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
from allset_tpu.nn import core

from allset_tpu.graph.batch import Batch
from allset_tpu.nn.modules import TorchDense
from allset_tpu.ops import gather_rows, segment_sum

Array = jax.Array


class HNHNConv(core.Module):
    hidden_channels: int
    out_channels: int
    nonlinear_inbetween: bool = True
    dtype: object = None  # jnp.bfloat16 for mixed precision

    @core.compact
    def __call__(self, x: Array, batch: Batch, train: bool = False) -> Array:
        inc = batch.inc
        ex = batch.extras

        from allset_tpu.ops.exchange import dir_spmm

        # The destination-side norms D_e_beta_inv[dst], D_v_alpha_inv[dst]
        # are constant per segment: pull them OUT of the reduces as table
        # scalings (segsum(norm[dst]*x[src]) == norm * segsum(x[src])), so
        # the fused spmm runs the unweighted path with no [nnz] norm
        # gathers fwd or bwd. With the N-slot self-loop split the per-edge
        # vectors are rearranged once: [real edges | per-node slots]
        # (slot values scattered by sl_node, zero at holes).
        split = inc.node_perm is not None and inc.real is not None
        if split:
            mr = inc.real.num_edges

            def slot(vec_e):
                tail = jnp.zeros((inc.num_nodes,), vec_e.dtype)
                tail = tail.at[inc.sl_node].set(vec_e[mr:][: inc.num_sl_edges])
                return jnp.concatenate([vec_e[:mr], tail])

            scale_e_out = slot(ex["D_e_beta_inv"])
            scale_e_in = slot(ex["D_e_alpha"])
        else:
            scale_e_out = ex["D_e_beta_inv"]
            scale_e_in = ex["D_e_alpha"]

        x = TorchDense(self.hidden_channels, dtype=self.dtype, name="weight_v2e")(x)
        x = ex["D_v_beta"][:, None].astype(x.dtype) * x
        # V->E: message norm_i = D_e_beta_inv at the destination edge
        if split:
            out = dir_spmm(x, inc.v2e_split())
            out = scale_e_out[:, None].astype(out.dtype) * out
        elif inc.node_perm is not None:
            out = dir_spmm(x, inc.v2e())
            out = scale_e_out[:, None].astype(out.dtype) * out
        else:
            msg = gather_rows(x, inc.node) * gather_rows(ex["D_e_beta_inv"], inc.edge)[:, None]
            msg = msg * inc.mask[:, None].astype(msg.dtype)
            out = segment_sum(msg, inc.edge, inc.num_edges, indices_are_sorted=True)

        if self.nonlinear_inbetween:
            out = jax.nn.relu(out)

        out = TorchDense(self.out_channels, dtype=self.dtype, name="weight_e2v")(out)
        out = scale_e_in[:, None].astype(out.dtype) * out
        # E->V: message norm_i = D_v_alpha_inv at the destination node
        if split:
            out = dir_spmm(out, inc.e2v_split())
            return ex["D_v_alpha_inv"][:, None].astype(out.dtype) * out
        if inc.node_perm is not None:
            out = dir_spmm(out, inc.e2v())
            return ex["D_v_alpha_inv"][:, None].astype(out.dtype) * out
        msg = gather_rows(out, inc.edge) * gather_rows(ex["D_v_alpha_inv"], inc.node)[:, None]
        msg = msg * inc.mask[:, None].astype(msg.dtype)
        return segment_sum(msg, inc.node, inc.num_nodes)


@dataclasses.dataclass(frozen=True)
class HNHNConfig:
    num_features: int
    num_classes: int
    all_num_layers: int = 2
    mlp_hidden: int = 64
    dropout: float = 0.5
    nonlinear_inbetween: bool = True
    dtype: str = "float32"  # 'bfloat16' -> mixed precision (f32 reduce accum)


class HNHN(core.Module):
    cfg: HNHNConfig

    @core.compact
    def __call__(self, batch: Batch, train: bool = False) -> Array:
        c = self.cfg
        dt = jnp.bfloat16 if c.dtype == "bfloat16" else None
        x = batch.x
        if dt is not None:
            x = x.astype(dt)
        if c.all_num_layers == 1:
            return HNHNConv(c.mlp_hidden, c.num_classes, c.nonlinear_inbetween,
                            dtype=dt, name="conv0")(x, batch, train).astype(jnp.float32)
        widths = [c.mlp_hidden] * (c.all_num_layers - 1) + [c.num_classes]
        for i, w in enumerate(widths):
            x = HNHNConv(c.mlp_hidden, w, c.nonlinear_inbetween, dtype=dt,
                         name=f"conv{i}")(x, batch, train)
            if i < len(widths) - 1:
                x = jax.nn.relu(x)
                x = core.Dropout(c.dropout)(x, deterministic=not train)
        return x.astype(jnp.float32)
