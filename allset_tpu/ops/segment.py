"""Segment primitives: the compute core of the framework.

Every hypergraph model in the AllSet capability surface decomposes into four
sparse primitives over the incidence COO (see reference
``src/layers.py:194,656`` for segment-reduce, ``src/layers.py:174`` for
segment-softmax, and the gather/scatter idiom of ``src/models.py:627-632``):

  * ``gather_rows``      — x[src] row gather                  (XLA dynamic-gather)
  * ``segment_sum/mean/max`` — reduce entries grouped by dst  (== SpMM w/ COO)
  * ``segment_softmax``  — softmax of entry scores grouped by dst (for PMA /
                           attention pooling; == the SDDMM-normalize step)

Design notes:
  * All shapes are static; ragged hypergraphs are handled by padding the nnz
    axis to a bucket. The padding convention is **out-of-range segment ids**:
    padded entries carry ``segment_ids == num_segments``, which XLA scatter
    drops (FILL_OR_DROP), so no dummy output row is ever materialized.
  * ``segment_softmax`` takes an explicit entry mask so padded entries
    contribute exactly 0 probability without NaNs.
  * These are the reference semantics; the sorted-order exchange ops in
    ``ops/exchange.py`` are validated against them.

Reduction semantics match torch_scatter 2.0.4 (the reference's backend):
  * mean divides by per-segment counts clamped to >= 1 (empty segments -> 0)
  * max returns 0 for empty segments (torch_scatter zero-initializes out)
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

Array = jax.Array

_NEG_BIG = -1e30  # softmax mask fill; avoids -inf NaN propagation


def gather_rows(x: Array, idx: Array) -> Array:
    """Row gather ``x[idx]`` with out-of-range indices clamped.

    Padded entries (idx possibly == num_rows) read the last row; callers must
    zero their contribution via norm/mask. Mirrors the source-gather half of
    PyG ``MessagePassing.propagate`` (reference ``src/layers.py:145``).
    """
    return jnp.take(x, idx, axis=0, mode="clip")


def segment_sum(
    data: Array,
    segment_ids: Array,
    num_segments: int,
    indices_are_sorted: bool = False,
) -> Array:
    """Sum of ``data`` rows grouped by ``segment_ids``.

    Out-of-range ids (the padding convention) are dropped. Equivalent to
    ``torch_scatter.scatter(..., reduce='add')`` at reference
    ``src/layers.py:194,656``.
    """
    return jax.ops.segment_sum(
        data,
        segment_ids,
        num_segments=num_segments,
        indices_are_sorted=indices_are_sorted,
    )


def segment_count(
    segment_ids: Array,
    num_segments: int,
    indices_are_sorted: bool = False,
) -> Array:
    """Number of (unpadded) entries per segment, as float32."""
    return jax.ops.segment_sum(
        jnp.ones(segment_ids.shape, dtype=jnp.float32),
        segment_ids,
        num_segments=num_segments,
        indices_are_sorted=indices_are_sorted,
    )


def segment_mean(
    data: Array,
    segment_ids: Array,
    num_segments: int,
    indices_are_sorted: bool = False,
) -> Array:
    """Mean of ``data`` rows per segment; empty segments -> 0.

    Matches torch_scatter reduce='mean' (count clamped to >= 1).
    """
    total = segment_sum(data, segment_ids, num_segments, indices_are_sorted)
    count = segment_count(segment_ids, num_segments, indices_are_sorted)
    count = jnp.maximum(count, 1.0).astype(total.dtype)
    return total / count.reshape((num_segments,) + (1,) * (total.ndim - 1))


def segment_max(
    data: Array,
    segment_ids: Array,
    num_segments: int,
    indices_are_sorted: bool = False,
) -> Array:
    """Max of ``data`` rows per segment; empty segments -> 0 (torch_scatter)."""
    out = jax.ops.segment_max(
        data,
        segment_ids,
        num_segments=num_segments,
        indices_are_sorted=indices_are_sorted,
    )
    # segment_max fills empty segments with -inf; torch_scatter uses 0.
    return jnp.where(jnp.isfinite(out), out, jnp.zeros_like(out))


_REDUCERS = {
    "add": segment_sum,
    "sum": segment_sum,
    "mean": segment_mean,
    "max": segment_max,
}


def segment_reduce(
    data: Array,
    segment_ids: Array,
    num_segments: int,
    reduce: str = "add",
    indices_are_sorted: bool = False,
) -> Array:
    """Dispatch on reduce in {'add'/'sum', 'mean', 'max'}.

    The aggregation dispatch of ``HalfNLHconv.aggregate`` (reference
    ``src/layers.py:641-656``).
    """
    try:
        fn = _REDUCERS[reduce]
    except KeyError:
        raise ValueError(f"Unknown reduce {reduce!r}; expected one of {sorted(_REDUCERS)}")
    return fn(data, segment_ids, num_segments, indices_are_sorted)


def segment_softmax(
    scores: Array,
    segment_ids: Array,
    num_segments: int,
    mask: Array | None = None,
    indices_are_sorted: bool = False,
) -> Array:
    """Softmax of per-entry ``scores`` grouped by destination segment.

    ``scores``: [nnz] or [nnz, H]. Per segment s: softmax over the entries
    with segment_ids == s, max-subtracted for stability. Entries with
    ``mask == False`` (or out-of-range ids) get probability exactly 0.

    Equivalent of ``torch_geometric.utils.softmax`` as used by PMA at
    reference ``src/layers.py:174`` and UniGATConv at ``src/models.py:834``.
    """
    if mask is not None:
        fill = jnp.asarray(_NEG_BIG, dtype=scores.dtype)
        mask_b = mask.reshape(mask.shape + (1,) * (scores.ndim - mask.ndim))
        scores = jnp.where(mask_b, scores, fill)

    seg_max = jax.ops.segment_max(
        scores,
        segment_ids,
        num_segments=num_segments,
        indices_are_sorted=indices_are_sorted,
    )
    # Empty segments hold -inf; neutralize so gathers stay finite.
    seg_max = jnp.where(jnp.isfinite(seg_max), seg_max, jnp.zeros_like(seg_max))
    shifted = scores - gather_rows(seg_max, segment_ids)
    expd = jnp.exp(shifted)
    if mask is not None:
        mask_b = mask.reshape(mask.shape + (1,) * (expd.ndim - mask.ndim))
        expd = jnp.where(mask_b, expd, jnp.zeros_like(expd))
    denom = segment_sum(expd, segment_ids, num_segments, indices_are_sorted)
    denom = jnp.maximum(denom, jnp.asarray(1e-16, dtype=expd.dtype))
    return expd / gather_rows(denom, segment_ids)


@functools.partial(jax.jit, static_argnames=("num_segments", "reduce", "indices_are_sorted"))
def propagate(
    x: Array,
    src: Array,
    dst: Array,
    norm: Array | None,
    num_segments: int,
    reduce: str = "add",
    indices_are_sorted: bool = False,
) -> Array:
    """gather -> (norm-scale) -> segment-reduce: the propagate() shape of the
    reference's message-passing layers (``src/layers.py:623-656``).

    ``norm`` is the per-incidence-entry weight (``data.norm``); it doubles as
    the padding mask (0 at padded entries).
    """
    msgs = gather_rows(x, src)
    if norm is not None:
        msgs = msgs * norm.reshape(norm.shape + (1,) * (msgs.ndim - 1)).astype(msgs.dtype)
    return segment_reduce(msgs, dst, num_segments, reduce, indices_are_sorted)
