"""Runs-folding primitives: vmap folds into the feature axis, not a loop.

The reference's canonical protocol trains ``runs`` (default 20) statistical
replicas of the same model on the same graph (``src/train.py:458-499``);
the Trainer vmaps them on-device. Under plain vmap, XLA serves every
gather/segment-reduce as a BATCHED op — R separate passes over the
incidence, each paying the per-row index traffic again.

Both hot ops are therefore JAX primitives here, with custom batching
rules that FOLD the mapped axis into the feature axis:

  * ``table_gather_p``:  [N, F] table batched over R  ->  one [N, R*F]
    table and ONE wide row gather (nnz index reads once, not R times).
  * ``sorted_segsum_p``: [nnz, F] messages batched over R  ->  one
    [nnz, R*F] sorted segment-sum; per-run accumulation is untouched
    (the reduce never mixes columns).

Outputs return with the batch axis at position 1 ([rows, R, F]), so
chained exchange ops stay folded with zero data movement; a moveaxis is
paid only where a batch-leading producer (GEMM outputs) feeds a fold.

Autodiff never sees these primitives: every caller wraps them in a
``jax.custom_vjp`` whose backward binds them again (ops/exchange.py).
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp
from jax.core import ShapedArray
from jax.extend.core import Primitive
from jax.interpreters import batching, mlir

Array = jax.Array


def _not_mapped(d) -> bool:
    return d is batching.not_mapped


# --- table_gather_p ---------------------------------------------------------

table_gather_p = Primitive("allset_table_gather")


def _gather_impl(table: Array, idx: Array) -> Array:
    return jnp.take(table, idx, axis=0, mode="clip")


def _gather_abstract(table, idx):
    return ShapedArray((idx.shape[0],) + tuple(table.shape[1:]), table.dtype)


def _gather_batch(args, dims):
    table, idx = args
    bt, bi = dims
    if not _not_mapped(bi):
        # batched indices (different graphs per batch member): one flat
        # gather with per-member row offsets — still a single gather pass.
        im = jnp.moveaxis(idx, bi, 0)  # [R, nnz]
        R, nnz = im.shape
        if _not_mapped(bt):
            out = table_gather_p.bind(table, im.reshape(-1))
            return out.reshape((R, nnz) + out.shape[1:]), 0
        tm = jnp.moveaxis(table, bt, 0)  # [R, N, ...]
        N = tm.shape[1]
        flat = tm.reshape((R * N,) + tm.shape[2:])
        off = jnp.clip(im, 0, N - 1) + (
            jnp.arange(R, dtype=im.dtype) * N
        )[:, None]
        out = table_gather_p.bind(flat, off.reshape(-1))
        return out.reshape((R, nnz) + out.shape[1:]), 0
    # table batched only (the vmapped-runs case): fold runs into the width
    t = jnp.moveaxis(table, bt, 1)  # [N, R, F] (free when bt == 1)
    N, R = t.shape[0], t.shape[1]
    tail = t.shape[2:]
    t2 = t.reshape(N, -1)
    out = table_gather_p.bind(t2, idx)
    return out.reshape((idx.shape[0], R) + tail), 1


table_gather_p.def_impl(_gather_impl)
table_gather_p.def_abstract_eval(_gather_abstract)
batching.primitive_batchers[table_gather_p] = _gather_batch
mlir.register_lowering(
    table_gather_p, mlir.lower_fun(_gather_impl, multiple_results=False)
)


def fold_gather(table: Array, idx: Array) -> Array:
    """Row gather ``table[idx]`` (clip mode) that stays ONE gather under
    vmap (runs folded into the row width). NOT differentiable — use only
    inside custom_vjp fwd/bwd bodies (ops/exchange wraps every use)."""
    return table_gather_p.bind(table, idx)


# --- sorted_segsum_p --------------------------------------------------------

sorted_segsum_p = Primitive("allset_sorted_segsum")


def _segsum_impl(msgs: Array, ids: Array, *, num_seg: int) -> Array:
    # float32 accumulation whatever the message dtype (bf16 sums would
    # lose the low bits of every long segment); result in msgs.dtype
    return jax.ops.segment_sum(
        msgs.astype(jnp.float32), ids, num_segments=num_seg,
        indices_are_sorted=True,
    ).astype(msgs.dtype)


def _segsum_abstract(msgs, ids, *, num_seg):
    return ShapedArray((num_seg, msgs.shape[1]), msgs.dtype)


def _segsum_batch(args, dims, *, num_seg):
    msgs, ids = args
    bm, bi = dims
    if not _not_mapped(bi):
        # batched segment structure (different graphs per batch member):
        # plain per-member reduce — correctness fallback, not a hot path.
        ii = jnp.moveaxis(ids, bi, 0)
        f = functools.partial(_segsum_impl, num_seg=num_seg)
        if _not_mapped(bm):
            out = jax.vmap(lambda i: f(msgs, i))(ii)
        else:
            out = jax.vmap(f)(jnp.moveaxis(msgs, bm, 0), ii)
        return out, 0
    # fold the mapped axis into the feature width: one pass for all runs
    # (columns never mix, so each run's sums are those of an unbatched call)
    m = jnp.moveaxis(msgs, bm, 1)  # [nnz, R, F] (free when bm == 1)
    tail = m.shape[2:]
    nnz, W = m.shape[0], math.prod(m.shape[1:])
    out = sorted_segsum_p.bind(m.reshape(nnz, W), ids, num_seg=num_seg)
    return out.reshape((num_seg,) + m.shape[1:2] + tail), 1


sorted_segsum_p.def_impl(_segsum_impl)
sorted_segsum_p.def_abstract_eval(_segsum_abstract)
batching.primitive_batchers[sorted_segsum_p] = _segsum_batch
mlir.register_lowering(
    sorted_segsum_p, mlir.lower_fun(_segsum_impl, multiple_results=False)
)


def fold_segsum(msgs: Array, ids: Array, num_seg: int) -> Array:
    """Sorted segment-sum (``ids`` ascending; out-of-range ids drop) that
    folds vmapped runs into one pass. f32 accumulation, result in
    msgs.dtype. NOT differentiable — callers wrap it in custom_vjp (the
    backward is a fold_gather of the cotangent)."""
    return sorted_segsum_p.bind(msgs, ids, num_seg=num_seg)
