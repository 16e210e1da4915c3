"""Bucketed exchange: slice every gather table into row ranges.

A row gather whose table outgrows a fast-memory window (a cache level, or
a software-managed scratchpad) can slow per row by a constant factor. This
module keeps each gather's table under ``bucket_rows`` rows.

Column-tiling cannot help: splitting a gather multiplies the row count
by the number of tiles. Row-bucketing the ENTRIES does: partition the
incidence entries by the gather-side id range so bucket k only ever reads
table rows [k*B, (k+1)*B) — a static row slice — while each bucket's
entries stay sorted by the reduce side, so every bucket runs the same
sorted segment-sum into a full-size partial output; partials sum. Total
gathered rows are unchanged (each entry is gathered exactly once, from a
small table).

The forward gathers from the SRC table and the backward from the DST
(cotangent) table, so the two passes need independent bucketings:

  * fwd aux: entries grouped by src-bucket, sorted by dst within;
  * bwd aux: entries grouped by dst-bucket, sorted by src within.

For a bipartite incidence the V2E forward aux is IDENTICAL to the E2V
backward aux (both: group by node bucket, reduce by edge) and vice
versa, so an Incidence carries just two structures (by_node, by_edge).

Overhead vs the unbucketed fused spmm: (K-1) extra partial-output
tables summed per pass. The aux is built only when the caller passes a
``bucket_rows`` threshold that a table side exceeds; by default it is off,
and whether a GPU has a cliff worth it is an open measurement.

Reference context: the torch reference has no analog (single dynamic
COO on cuSPARSE, ``src/utils.py:59-82``).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from allset_tpu.ops.fold import fold_gather, fold_segsum

Array = jax.Array


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class BucketSide:
    """One bucket of one pass: gather rows [table_offset, +table_rows) of
    the gather-side table, reduce by ``red_ids`` (sorted, full reduce-side
    id space). Padded entries carry gather_local == table_rows (clip) and
    red_ids == num_red (out of range: the reduce drops them)."""

    gather_local: Array  # i32[nnz_pad] row ids within the table slice
    red_ids: Array  # i32[nnz_pad] reduce segment ids, ascending
    perm_canon: Array  # i32[nnz_pad] canonical entry positions (norm gather)
    table_offset: int = dataclasses.field(metadata=dict(static=True))
    table_rows: int = dataclasses.field(metadata=dict(static=True))
    num_red: int = dataclasses.field(metadata=dict(static=True))
    nnz: int = dataclasses.field(metadata=dict(static=True))


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class BucketedDir:
    """Both passes of one exchange direction (see module docstring)."""

    fwd: Tuple[BucketSide, ...]  # gather src-table slices, reduce by dst
    bwd: Tuple[BucketSide, ...]  # gather dst-table slices, reduce by src


def build_bucket_side(
    gather_ids: np.ndarray,
    red_ids: np.ndarray,
    num_gather: int,
    num_red: int,
    bucket_rows: int,
) -> Tuple[BucketSide, ...]:
    """Host-side: partition VALID entries (canonical order) by gather-id
    range, sort each bucket by reduce id, pad to a static bucket."""
    from allset_tpu.graph import native
    from allset_tpu.graph.incidence import pad_bucket

    K = max(1, -(-num_gather // bucket_rows))
    sides = []
    for k in range(K):
        lo = k * bucket_rows
        rows = min(bucket_rows, num_gather - lo)
        sel = np.flatnonzero((gather_ids >= lo) & (gather_ids < lo + rows))
        g = (gather_ids[sel] - lo).astype(np.int32)
        r = red_ids[sel].astype(np.int32)
        order = native.stable_argsort(r, num_red + 1)
        g, r, pos = g[order], r[order], sel[order]
        nnz_k = len(sel)
        npad = pad_bucket(max(nnz_k, 1))
        pad = npad - nnz_k
        sides.append(
            BucketSide(
                gather_local=jnp.asarray(
                    np.concatenate([g, np.full(pad, rows, np.int32)])
                ),
                red_ids=jnp.asarray(
                    np.concatenate(
                        [r, np.full(pad, num_red, np.int32)]
                    )
                ),
                perm_canon=jnp.asarray(
                    np.concatenate(
                        [pos.astype(np.int32), np.zeros(pad, np.int32)]
                    )
                ),
                table_offset=lo,
                table_rows=rows,
                num_red=num_red,
                nnz=nnz_k,
            )
        )
    return tuple(sides)


def _one_pass(table: Array, sides, norm_traced, has_norm: bool) -> Array:
    """Σ_k sorted-reduce(gather(table slice k)) -> [num_red, F] in
    table.dtype (f32 accumulation inside each reduce; K > 1 partials sum
    in f32). Entry weights come from ``norm_traced`` (canonical order)
    via each bucket's perm_canon — a [nnz] gather, negligible next to
    the [nnz, F] row traffic. Padded entries may read nonzero norms;
    their out-of-range reduce ids drop them either way."""
    out = None
    for s in sides:
        sl = jax.lax.slice_in_dim(table, s.table_offset,
                                  s.table_offset + s.table_rows, axis=0)
        msgs = fold_gather(sl, s.gather_local)
        if has_norm:
            w = fold_gather(norm_traced, s.perm_canon)
            msgs = msgs * w[:, None].astype(msgs.dtype)
        part = fold_segsum(msgs, s.red_ids, s.num_red)
        if len(sides) == 1:
            return part
        out = part.astype(jnp.float32) if out is None else out + part.astype(jnp.float32)
    return out.astype(table.dtype)


@functools.partial(jax.custom_vjp, nondiff_argnums=(0,))
def _bspmm(meta, w, norm, bd):
    has_norm = meta[0]
    return _one_pass(w, bd.fwd, norm if has_norm else None, has_norm)


def _bspmm_fwd(meta, w, norm, bd):
    out = _bspmm(meta, w, norm, bd)
    return out, (norm, bd, jnp.zeros((0,), w.dtype))


def _bspmm_bwd(meta, res, g):
    has_norm = meta[0]
    norm, bd, dtok = res
    gb = g.astype(dtok.dtype)
    dw = _one_pass(gb, bd.bwd, norm if has_norm else None, has_norm)
    return dw.astype(dtok.dtype), None, None


_bspmm.defvjp(_bspmm_fwd, _bspmm_bwd)


def bucketed_spmm(w: Array, bd: BucketedDir, norm: Optional[Array]) -> Array:
    """out[m] = Σ_{i: dst_i = m} norm_i * w[src_i] with every gather
    table sliced to at most ``bucket_rows`` rows. ``norm`` (traced, canonical entry
    order) multiplies the baked per-bucket norms when given; gradients
    flow to ``w`` only (LearnMask norm gradients take the unbucketed
    fused path — ops/exchange._core_reduce routes accordingly)."""
    meta = (norm is not None,)
    narg = norm if norm is not None else jnp.zeros((0,), jnp.float32)
    return _bspmm(meta, w, narg, bd)
