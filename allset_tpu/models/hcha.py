"""HCHA / HGNN: Hypergraph Convolution (+ optional attention).

Reference ``src/layers.py:318-494`` (HypergraphConv) and
``src/models.py:252-292`` (HCHA wrapper). Math (Bai et al. 2019):

    X' = D^-1 H W B^-1 H^T X Theta          (asymmetric, HCHA)
    X' = D^-1/2 H W B^-1 H^T D^-1/2 X Theta (symdegnorm=True -> HGNN;
                                             factory: src/train.py:77-82)

computed as two propagate passes over the incidence: V->E with norm
B^-1 (1/edge-degree), then E->V with norm D^-1 (or the D^-1/2 split).
Degrees are built on-device with segment sums, matching the scatter_add
builders at ``src/layers.py:436-470``. The optional attention path
(``src/layers.py:427-434``, off by default) scores each incidence entry
with att . [x_i || x_e] and softmaxes over the node's entries.
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


def _safe_inv(x: Array, power: float = 1.0) -> Array:
    """1/x**power with empty (0) degrees -> 0, as the reference's
    ``D[D == inf] = 0`` lines (src/layers.py:439-445)."""
    inv = jnp.where(x > 0, x ** -power, jnp.zeros_like(x))
    return inv


class HypergraphConv(core.Module):
    out_channels: int
    symdegnorm: bool = False
    use_attention: bool = False
    heads: int = 1
    concat: bool = True
    negative_slope: float = 0.2
    dropout: float = 0.0
    use_bias: bool = True
    dtype: object = None  # jnp.bfloat16 for mixed precision

    @core.compact
    def __call__(self, x: Array, batch: Batch, train: bool = False) -> Array:
        inc = batch.inc
        n, m = inc.num_nodes, inc.num_edges
        H = self.heads if self.use_attention else 1
        F = self.out_channels

        weight = self.param(
            "weight", glorot_uniform(), (x.shape[-1], H * F)
        )
        if self.dtype is not None:
            x = x.astype(self.dtype)
            weight = weight.astype(self.dtype)
        x = x @ weight

        alpha = None
        if self.use_attention:
            # flat [rows, H*F] layout; per-head scores via a reshaped view
            # of the small [1,H,2F] att param.
            att = self.param("att", xavier_uniform_torch_fans((1, H, 2 * F)), (1, H, 2 * F))
            att_i, att_e = att[..., :F], att[..., F:]
            s_i = (x.reshape(-1, H, F) * att_i).sum(-1)  # [N, H]
            s_e = (x.reshape(-1, H, F) * att_e).sum(-1)
            alpha = gather_rows(s_i, inc.node) + gather_rows(
                s_e, jnp.minimum(inc.edge, n - 1)  # ref indexes x by he id
            )
            alpha = jax.nn.leaky_relu(alpha, self.negative_slope)
            alpha = segment_softmax(alpha, inc.node, n, mask=inc.mask)
            alpha = core.Dropout(self.dropout)(alpha, deterministic=not train)

        # D: weighted node degree (hyperedge weights are all-ones here, as
        # in the reference default), B: edge cardinality. Both are static
        # graph quantities: prefer the incidence's precomputed counts over
        # recomputing width-1 segment sums every step.
        if inc.node_count is not None:
            D, B = inc.node_count, inc.edge_count
        else:
            ones = inc.norm_ones()
            D = segment_sum(ones, inc.node, n)
            B = segment_sum(ones, inc.edge, m, indices_are_sorted=True)
        Binv = _safe_inv(B)

        if not self.symdegnorm:
            Dinv = _safe_inv(D)
        else:
            Dinv = _safe_inv(D, 0.5)
            x = Dinv[:, None].astype(x.dtype) * x

        def prop(h, src, dst, num_seg, norm_dst, sorted_):
            msg = gather_rows(h, src) * gather_rows(norm_dst, dst)[:, None]
            if alpha is not None:
                msg = msg * _head_expand(alpha.astype(msg.dtype), F)
            return segment_sum(msg, dst, num_seg, indices_are_sorted=sorted_)

        shex = getattr(batch, "shex", None)
        if alpha is None and (shex is not None or inc.node_perm is not None):
            # Sorted-everywhere exchange. The message norms B^-1[dst],
            # D^-*[dst] are constant per destination segment, so they pull
            # OUT of the reduce as table scalings: segsum(norm[dst]*x[src])
            # == norm * segsum(x[src]). The fused spmm then runs the
            # unweighted (PMA-style) path — no [nnz] norm gathers forward,
            # and no src-sorted norm permute in the backward.
            from allset_tpu.ops.exchange import dir_spmm

            if shex is not None:
                # explicit shard_map edge-partitioned exchange (multi-chip;
                # parallel/sharded.py — fwd one reassembly all-gather, bwd
                # one dw psum per direction). Split and unsplit builds both
                # compose: sl_mode tells which scale_e layout applies.
                dv, de = shex.v2e, shex.e2v
                if dv.sl_mode == "append":
                    # ShardedExchange.build sets sl_mode='append' iff
                    # inc.real is not None (parallel/sharded.py invariant)
                    assert inc.real is not None and inc.sl_mask is not None
                    scale_e = jnp.concatenate(
                        [_safe_inv(inc.real.edge_count), inc.sl_mask]
                    )
                else:
                    scale_e = Binv
            elif inc.real is not None:
                # N-slot self-loop split: the sparse core covers real
                # edges only; self-loop slots are identity rows with B=1,
                # holes zeroed by sl_mask
                dv, de = inc.v2e_split(), inc.e2v_split()
                scale_e = jnp.concatenate(
                    [_safe_inv(inc.real.edge_count), inc.sl_mask]
                )
            else:
                dv, de = inc.v2e(), inc.e2v()
                scale_e = Binv
            out = dir_spmm(x, dv) * scale_e[:, None].astype(x.dtype)
            out = dir_spmm(out, de)
            out = out * Dinv[:, None].astype(out.dtype)
        else:
            out = prop(x, inc.node, inc.edge, m, Binv, True)  # V->E, norm B^-1
            out = prop(out, inc.edge, inc.node, n, Dinv, False)  # E->V, norm D^-*

        if self.use_attention and not self.concat:
            out = out.reshape(-1, H, F).mean(axis=1)
        if self.use_bias:
            bias = self.param("bias", jax.nn.initializers.zeros, (H * F if (self.use_attention and self.concat) else F,))
            out = out + bias.astype(out.dtype)
        return out


@dataclasses.dataclass(frozen=True)
class HCHAConfig:
    num_features: int
    num_classes: int
    all_num_layers: int = 2
    mlp_hidden: int = 64
    dropout: float = 0.5
    symdegnorm: bool = False  # True -> the HGNN variant
    dtype: str = "float32"  # 'bfloat16' -> mixed precision


class HCHA(core.Module):
    """Stack of HypergraphConv with ELU + dropout (``src/models.py:280-292``)."""

    cfg: HCHAConfig

    @core.compact
    def __call__(self, batch: Batch, train: bool = False) -> Array:
        c = self.cfg
        dt = jnp.bfloat16 if c.dtype == "bfloat16" else None
        x = batch.x
        widths = [c.mlp_hidden] * (c.all_num_layers - 1) + [c.num_classes]
        for i, w in enumerate(widths):
            conv = HypergraphConv(out_channels=w, symdegnorm=c.symdegnorm,
                                  dtype=dt, name=f"conv{i}")
            x = conv(x, batch, train)
            if i < len(widths) - 1:
                x = jax.nn.elu(x)
                x = core.Dropout(c.dropout)(x, deterministic=not train)
        return x.astype(jnp.float32)
