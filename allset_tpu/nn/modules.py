"""Core neural modules: MLP, PMA (attention pooling), HalfNLHconv.

These are the building blocks of the SetGNN family (reference
``src/layers.py``), re-expressed as ``nn.core`` modules over the segment
primitives of ``allset_tpu.ops``. Math and init follow the reference
exactly (per-layer allclose parity is tested in
``tests/test_parity_setgnn.py``); the execution model is pure-functional
and jit-compiled end to end.
"""

from __future__ import annotations

from typing import Callable, Optional

import jax
import jax.numpy as jnp
from allset_tpu.nn import core

from allset_tpu.nn.init import (
    glorot_uniform,
    torch_linear_bias,
    torch_linear_kernel,
    xavier_uniform_torch_fans,
)
from allset_tpu.graph.incidence import Direction
from allset_tpu.ops import segment_softmax
from allset_tpu.ops.exchange import dir_gather, dir_reduce, dir_spmm

Array = jax.Array

LN_EPS = 1e-5  # torch LayerNorm default
BN_MOMENTUM = 0.9  # running-average momentum == 1 - torch momentum (0.1)


def _head_expand(a: Array, C: int) -> Array:
    """Per-head column expansion [rows, H] -> [rows, H*C]: column h*C + c
    copies column h."""
    return jnp.repeat(a, C, axis=1)


def _declare_dense_params(mod: core.Module, fan_in: int, features: int,
                          kernel_init: Optional[Callable]):
    """The single source of truth for TorchDense's param scheme (names,
    shapes, torch nn.Linear default inits) — shared with _DenseParams so
    declare-only layers (PMA's folded lin_K) can never drift from it."""
    kinit = kernel_init if kernel_init is not None else torch_linear_kernel()
    kernel = mod.param("kernel", kinit, (fan_in, features))
    bias = mod.param("bias", torch_linear_bias(fan_in), (features,))
    return kernel, bias


class TorchDense(core.Module):
    """Dense layer with torch ``nn.Linear`` default init:
    weight and bias ~ U(±1/sqrt(fan_in))."""

    features: int
    use_bias: bool = True
    kernel_init: Optional[Callable] = None
    dtype: Optional[jnp.dtype] = None  # compute dtype; params stay float32

    @core.compact
    def __call__(self, x: Array) -> Array:
        fan_in = x.shape[-1]
        if self.use_bias:
            kernel, bias = _declare_dense_params(
                self, fan_in, self.features, self.kernel_init
            )
        else:
            kinit = self.kernel_init if self.kernel_init is not None else torch_linear_kernel()
            kernel = self.param("kernel", kinit, (fan_in, self.features))
        if self.dtype is not None:
            x = x.astype(self.dtype)
            kernel = kernel.astype(self.dtype)
        y = x @ kernel
        if self.use_bias:
            y = y + bias.astype(y.dtype)
        return y


class _DenseParams(core.Module):
    """Declare TorchDense-compatible params (same scope/names/inits via
    the shared _declare_dense_params helper) WITHOUT computing the dense
    product — for layers whose output is only ever consumed through a
    low-rank projection (PMA's folded lin_K)."""

    features: int
    fan_in: int
    kernel_init: Optional[Callable] = None

    @core.compact
    def __call__(self):
        return _declare_dense_params(self, self.fan_in, self.features, self.kernel_init)


class NormLayer(core.Module):
    """'bn' | 'ln' | 'None' normalization (reference MLP's per-layer
    normalizations, ``src/layers.py:506-560``). Statistics always compute
    in float32; ``dtype`` controls the output/activation dtype."""

    kind: str
    dtype: Optional[jnp.dtype] = None

    @core.compact
    def __call__(self, x: Array, train: bool) -> Array:
        if self.kind == "bn":
            return core.BatchNorm(
                use_running_average=not train,
                momentum=BN_MOMENTUM,
                epsilon=LN_EPS,
                dtype=self.dtype,
            )(x)
        if self.kind == "ln":
            return core.LayerNorm(epsilon=LN_EPS, dtype=self.dtype)(x)
        if self.kind in ("None", "none", None):
            return x
        raise ValueError(f"unknown normalization {self.kind!r}")


class MLP(core.Module):
    """N-layer MLP with per-layer normalization, ReLU, dropout; optional
    InputNorm; 1 layer degenerates to a linear classifier.

    Mirrors reference ``MLP`` (``src/layers.py:496-579``): input-norm (or
    identity) first, then for each hidden layer lin -> relu -> norm ->
    dropout, then the final linear.
    """

    hidden_channels: int
    out_channels: int
    num_layers: int
    dropout: float = 0.5
    normalization: str = "bn"
    input_norm: bool = False
    dtype: Optional[jnp.dtype] = None

    @core.compact
    def __call__(self, x: Array, train: bool = False) -> Array:
        if self.input_norm:
            x = NormLayer(self.normalization, dtype=self.dtype, name="input_norm")(x, train)
        for i in range(self.num_layers - 1):
            x = TorchDense(self.hidden_channels, dtype=self.dtype, name=f"lin{i}")(x)
            x = jax.nn.relu(x)
            x = NormLayer(self.normalization, dtype=self.dtype, name=f"norm{i}")(x, train)
            x = core.Dropout(self.dropout)(x, deterministic=not train)
        x = TorchDense(self.out_channels, dtype=self.dtype, name=f"lin{self.num_layers - 1}")(x)
        return x


class PMA(core.Module):
    """Pooling by Multihead Attention with a learned seed vector per head.

    Set-Transformer-style pooling of each destination segment's multiset
    (reference ``src/layers.py:42-199``):

      x_K = lin_K(x); x_V = lin_V(x)                 (glorot weights)
      alpha = (x_K * att_r).sum(-1)                  seed-key scores [N, H]
      per-segment softmax(leaky_relu(alpha, 0.2))    over entries by dst
      out  = segment-sum(alpha * x_V) + att_r        seed residual
      out  = ln1(z + relu(rFF(z))),  z = ln0(concat-heads(out))

    Heads split the hidden dim: C = hid_dim // heads; aggregation is
    hard-coded 'add' and attention dropout 0 (``src/layers.py:63-64``).
    """

    hid_dim: int
    out_dim: int
    num_layers: int
    heads: int = 1
    negative_slope: float = 0.2
    dtype: Optional[jnp.dtype] = None  # activation dtype; exp/softmax in f32
    # 'global': one global max per head stabilizes the softmax — exactly
    # softmax in real arithmetic (shift invariance); differs from the
    # per-segment-max form only if a segment's scores sit >87 nats below
    # the global max (f32 exp underflow), which trained attention logits
    # never approach. Makes exp(alpha) a PER-SOURCE quantity, so attention
    # weighting happens on the [rows, F] source table before the gather —
    # no [nnz, *] elementwise pass and no narrow [nnz, H] segment op.
    # 'segment': the reference's per-segment max (PyG softmax) — exact
    # parity mode.
    softmax_mode: str = "global"
    # parity with the reference's return_attention_weights option
    # (``src/layers.py:159-164``): when True, __call__ returns
    # (out, alpha) where alpha[i, h] is entry i's softmax weight for its
    # destination segment (covers the entries of ``d``; with a self-loop
    # split Direction that's the real edges — self-loop weights are 1).
    return_attention: bool = False
    # apply the caller's post-PMA activation (SetGNN's inter-stage relu,
    # ``src/models.py:475-479``) at the end of this module
    fold_relu: bool = False

    @core.compact
    def __call__(
        self,
        x: Array,
        d: Direction,
        train: bool = False,
    ) -> Array:
        H = self.heads
        C = self.hid_dim // H
        HC = H * C
        num_segments = d.num_dst

        # lin_K's output is consumed ONLY through the per-head seed
        # projection (alpha = (x_K * att_r).sum over C), which is linear:
        # fold it into the kernel — alpha = x @ (W_K . P) + b_K . P with
        # P the [HC, H] block-diagonal seed expansion. This removes the
        # whole [rows, HC] x_K GEMM and its device-memory round trip, exactly.
        WK, bK = _DenseParams(HC, x.shape[-1], glorot_uniform(), name="lin_K")()
        WV, bV = _DenseParams(HC, x.shape[-1], glorot_uniform(), name="lin_V")()

        att_r = self.param("att_r", xavier_uniform_torch_fans((1, H, C)), (1, H, C))
        att_flat = att_r.reshape(HC)
        # The per-head seed scores alpha = sum_c K[:,h,c] * att_r[h,c] become
        # one GEMM against a block-diagonal [HC, H] expansion of the seed,
        # and the attention weights e = exp(leaky(alpha) - globalmax) are
        # applied at the SOURCE rows and ride along in the value gather +
        # flat segment-sum as H extra denominator columns.
        blk = (
            jax.lax.broadcasted_iota(jnp.int32, (HC, H), 0) // C
            == jax.lax.broadcasted_iota(jnp.int32, (HC, H), 1)
        )
        proj = jnp.where(blk, att_flat[:, None], 0.0)
        Wa = WK @ proj  # [in_dim, H] (f32 param math; tiny)
        ba = bK @ proj  # [H]
        xc = x.astype(self.dtype) if self.dtype is not None else x
        # ONE GEMM computes [values | seed scores]: the H-column alpha GEMM
        # and its backward GEMMs fold into lin_V's. Biases stay separate
        # adds so alpha keeps its f32 bias math; both fuse into consumers.
        Wf = jnp.concatenate([WV, Wa], axis=1)  # [in_dim, HC+H] f32 params
        yf = xc @ Wf.astype(xc.dtype)
        x_V = yf[:, :HC] + bV.astype(yf.dtype)
        alpha = yf[:, HC : HC + H].astype(jnp.float32) + ba[None, :]
        alpha = jax.nn.leaky_relu(alpha, self.negative_slope)

        if self.softmax_mode == "segment":
            # parity path: per-segment max softmax; does not compose with
            # the self-loop split layout (SetGNN only builds split
            # Directions for the default 'global' mode)
            assert getattr(d, "sl_mode", "none") == "none", (
                "PMA softmax_mode='segment' requires an unsplit Direction"
            )
            packed = jnp.concatenate([x_V, alpha.astype(x_V.dtype)], axis=1)
            g = dir_gather(packed, d)
            x_j, a_j = g[:, :HC], g[:, HC:].astype(jnp.float32)
            p = segment_softmax(
                a_j, d.dst, num_segments, mask=d.mask,
                indices_are_sorted=d.dst_is_sorted,
            )
            out = dir_reduce(
                x_j * _head_expand(p.astype(x_j.dtype), C), d, "add"
            )
            attn = p
        else:
            # Padded entries carry out-of-range src/dst ids: the clip-gather
            # reads garbage rows but the reduce drops their segment, and the
            # gather's backward drops them symmetrically — no masking needed.
            gmax = jax.lax.stop_gradient(jnp.max(alpha, axis=0))  # [H]
            gmax = jnp.maximum(gmax, 0.0)  # empty-table guard (exp finite)
            e = jnp.exp(alpha - gmax[None, :]).astype(x_V.dtype)  # <= 1
            w = jnp.concatenate([x_V * _head_expand(e, C), e], axis=1)
            agg = dir_spmm(w, d)  # fused gather+reduce, permute-free bwd
            out, denom_h = head_normalize(agg, H)
            if self.return_attention:
                # per-entry weight = e[src] / denom[dst] (debug/parity API;
                # single-device Directions only — sharded src/dst are [D, .])
                assert getattr(d, "mesh", None) is None, (
                    "return_attention requires a single-device Direction"
                )
                e_j = jnp.take(e, d.src, axis=0, mode="clip")
                den_j = jnp.take(denom_h, d.dst, axis=0, mode="clip")
                attn = (e_j.astype(jnp.float32) / den_j.astype(jnp.float32))

        out = pma_epilogue(out, att_flat, self.out_dim, self.num_layers,
                           self.dtype, self.fold_relu, train)
        if self.return_attention:
            return out, attn
        return out


def head_normalize(agg: Array, heads: int):
    """Split PMA's aggregate [M, HC + H] = [weighted values | per-head
    softmax denominators] into the per-head-normalized values [M, HC] and
    the (floored) denominators [M, H]."""
    HC = agg.shape[1] - heads
    denom_h = jnp.maximum(agg[:, HC:], 1e-16)
    return agg[:, :HC] / _head_expand(denom_h, HC // heads), denom_h


def pma_epilogue(out: Array, seed: Array, out_dim: int, num_layers: int,
                 dtype=None, relu: bool = False, train: bool = False) -> Array:
    """PMA's row-local tail (reference ``src/layers.py:150-157``):
    ``ln1(z + relu(rFF(z)))`` with ``z = ln0(out + seed)``, then a relu
    when ``relu``. Call it inside a compact method: its ``ln0``, ``rFF``
    and ``ln1`` submodules bind to the caller's scope."""
    out = out + seed[None, :].astype(out.dtype)  # seed residual (src/layers.py:153)
    out = core.LayerNorm(epsilon=LN_EPS, dtype=dtype, name="ln0")(out)
    rff = MLP(
        hidden_channels=seed.shape[-1],
        out_channels=out_dim,
        num_layers=num_layers,
        dropout=0.0,
        normalization="None",
        dtype=dtype,
        name="rFF",
    )
    out = core.LayerNorm(epsilon=LN_EPS, dtype=dtype, name="ln1")(
        out + jax.nn.relu(rff(out, train)).astype(out.dtype)
    )
    return jax.nn.relu(out) if relu else out


class HalfNLHconv(core.Module):
    """One directed half-layer of multiset message passing
    (reference ``src/layers.py:582-656``).

    attention=True  -> PMA pooling (AllSetTransformer half-layer)
    attention=False -> Deep Sets rho(sum phi(x)): relu(f_enc MLP) ->
                       dropout -> propagate(norm, aggr) -> relu(f_dec MLP).
                       With num_layers == 0 the MLPs are identity but the
                       relus remain (faithful to ``src/layers.py:631-634``).
    """

    hid_dim: int
    out_dim: int
    num_layers: int
    dropout: float = 0.5
    normalization: str = "ln"
    input_norm: bool = False
    heads: int = 1
    attention: bool = True
    dtype: Optional[jnp.dtype] = None
    # True when d.norm requires gradients (SetGNN LearnMask): the fused
    # spmm then adds an SDDMM pass for dnorm; False declares dnorm = 0
    norm_grad: bool = False
    # fold the caller's post-layer relu (see PMA.fold_relu). The DeepSets
    # path already ends in relu (``src/layers.py:634``), making a caller
    # relu idempotent, so the flag only matters on the attention path.
    fold_relu: bool = False

    @core.compact
    def __call__(
        self,
        x: Array,
        d: Direction,
        aggr: str = "add",
        train: bool = False,
    ) -> Array:
        if self.attention:
            return PMA(
                hid_dim=self.hid_dim,
                out_dim=self.out_dim,
                num_layers=self.num_layers,
                heads=self.heads,
                dtype=self.dtype,
                fold_relu=self.fold_relu,
                name="prop",
            )(x, d, train)

        if self.num_layers > 0:
            x = MLP(
                hidden_channels=self.hid_dim,
                out_channels=self.hid_dim,
                num_layers=self.num_layers,
                dropout=self.dropout,
                normalization=self.normalization,
                input_norm=self.input_norm,
                dtype=self.dtype,
                name="f_enc",
            )(x, train)
        x = jax.nn.relu(x)
        x = core.Dropout(self.dropout)(x, deterministic=not train)
        dtype = x.dtype
        x = dir_spmm(x, d, norm=d.norm, reduce=aggr, norm_grad=self.norm_grad).astype(dtype)
        if self.num_layers > 0:
            x = MLP(
                hidden_channels=self.hid_dim,
                out_channels=self.out_dim,
                num_layers=self.num_layers,
                dropout=self.dropout,
                normalization=self.normalization,
                input_norm=self.input_norm,
                dtype=self.dtype,
                name="f_dec",
            )(x, train)
        x = jax.nn.relu(x)
        return x
