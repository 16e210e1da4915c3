"""Directed bipartite exchange ops: sorted-everywhere gather/reduce.

The hot loop of every hypergraph model here is ``gather x[src] ->
elementwise -> segment-reduce by dst`` per direction, forward and backward
(reference idiom at ``src/models.py:627-632``; PMA at ``src/layers.py:
128-194``). A sorted segment-sum lets XLA reduce each segment's run of
entries in order; an unsorted scatter-add cannot assume that.

A naive implementation pays the unsorted price twice per direction: the
forward E->V reduce (node ids unsorted in canonical order) and the backward
of each gather (XLA autodiff emits a plain scatter-add). These ops remove
every unsorted reduce from the program using the two entry orderings
precomputed on ``Incidence`` (edge-sorted canonical + node-sorted second
order, ``graph/incidence.py``):

  * ``dir_reduce(msgs, d)``  — forward reduce over ``d.dst`` (always
    ascending by construction): XLA segment_sum with the sorted hint.
    Backward is a row gather.
  * ``dir_gather(x, d)``     — forward ``x[d.src]``; custom VJP backward =
    permute the cotangent into src-sorted order (one [nnz, F] gather) and
    sorted-segment-sum it, instead of XLA's unsorted scatter.

Every op here is plain XLA, so GSPMD partitions it over a mesh as it
stands.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from allset_tpu.graph.incidence import Direction
from allset_tpu.ops.fold import fold_gather, fold_segsum
from allset_tpu.ops.segment import segment_max as _xla_segment_max

Array = jax.Array


@functools.partial(jax.custom_vjp, nondiff_argnums=(0,))
def _sorted_sum(num_seg, msgs, ids):
    """Sorted segment-sum of ``msgs`` by ascending ``ids`` -> [num_seg, F]
    in msgs.dtype, accumulated in float32 (bf16 in -> bf16 out: halves the
    write and the downstream elementwise traffic). Folds vmapped runs into
    one pass (ops/fold.py)."""
    return fold_segsum(msgs, ids, num_seg)


def _sorted_sum_fwd(num_seg, msgs, ids):
    return _sorted_sum(num_seg, msgs, ids), (ids, jnp.zeros((0,), msgs.dtype))


def _sorted_sum_bwd(num_seg, res, g):
    # d msgs = g[ids]; padded entries read a garbage row, but their message
    # contribution is zeroed upstream (norm/mask discipline), so their
    # cotangent is never consumed.
    ids, tok = res
    return (fold_gather(g, ids).astype(tok.dtype), None)


_sorted_sum.defvjp(_sorted_sum_fwd, _sorted_sum_bwd)


def dir_reduce(msgs: Array, d: Direction, reduce: str = "add") -> Array:
    """Segment-reduce ``msgs`` (execution order) by ``d.dst`` -> [num_dst, F].

    Accumulation is float32; the result dtype follows msgs on the sorted
    path. 'mean' divides by the static per-destination valid-entry count
    (clamped to >= 1, torch_scatter semantics). 'max' falls back to XLA
    segment-max (rare path).
    """
    if reduce in ("add", "sum", "mean"):
        if d.dst_is_sorted:
            out = _sorted_sum(d.num_dst, msgs, d.dst)
        else:
            out = jax.ops.segment_sum(
                msgs.astype(jnp.float32), d.dst, num_segments=d.num_dst
            )
        if reduce == "mean":
            if d.dst_count is not None:
                cnt = d.dst_count
            else:
                cnt = jax.ops.segment_sum(
                    d.mask.astype(jnp.float32),
                    d.dst,
                    num_segments=d.num_dst,
                    indices_are_sorted=d.dst_is_sorted,
                )
            out = out / jnp.maximum(cnt, 1.0)[:, None].astype(out.dtype)
        return out
    if reduce == "max":
        return _xla_segment_max(
            msgs, d.dst, d.num_dst, indices_are_sorted=d.dst_is_sorted
        )
    raise ValueError(f"unknown reduce {reduce!r}")


@functools.partial(jax.custom_vjp, nondiff_argnums=(0,))
def _gather(meta, x, src, perm, src_sorted):
    return fold_gather(x, src)


def _gather_fwd(meta, x, src, perm, src_sorted):
    out = fold_gather(x, src)
    return out, (src, perm, src_sorted)


def _gather_bwd(meta, res, g):
    num_src, nrows = meta
    src, perm, src_sorted = res
    if perm is not None and nrows == num_src:
        dx = fold_segsum(fold_gather(g, perm), src_sorted, num_src)
    else:
        dx = jax.ops.segment_sum(g.astype(jnp.float32), src, num_segments=nrows)
    return dx.astype(g.dtype), None, None, None


_gather.defvjp(_gather_fwd, _gather_bwd)


def dir_gather(x: Array, d: Direction) -> Array:
    """Row gather ``x[d.src]`` whose backward is a SORTED segment-sum
    (cotangent permuted into src-sorted order, then the hinted XLA
    reduce) instead of XLA's unsorted scatter-add.

    Requires zero cotangent at padded entries — guaranteed by the
    norm/mask discipline (see Direction docstring). Under vmap the
    gather and the backward reduce both FOLD the mapped axis into the
    row width — one pass for all runs (ops/fold.py).
    """
    meta = (d.num_src, x.shape[0])
    return _gather(meta, x, d.src, d.perm_srcsort, d.src_sorted)


def dir_propagate(
    x: Array, d: Direction, norm: Array | None = None, reduce: str = "add"
) -> Array:
    """gather -> (norm-scale) -> sorted segment-reduce (the propagate()
    shape of the reference's layers, with every reduce sorted)."""
    msgs = dir_gather(x, d)
    w = d.norm if norm is None else norm
    if w is not None:
        msgs = msgs * w[:, None].astype(msgs.dtype)
    return dir_reduce(msgs, d, reduce)


# --- fused spmm: gather -> scale -> reduce with a permute-free backward ----
#
# out[m] = sum_{i: dst_i = m} norm_i * w[src_i]        (one direction of the
# bipartite exchange; norm absent for the PMA path, which pre-scales rows).
#
# Composing dir_gather + dir_reduce pays, in the backward, a random [nnz, F]
# permute of the cotangent into src-sorted order (an nnz-row gather from an
# nnz-row table, the largest table of the exchange).
# The fused VJP never touches nnz-major tables:
#
#   dw[s] = sum_{i: src_i = s} norm_i * g[dst_i]
#
# evaluated by iterating entries in SRC-SORTED order: one row-gather from the
# [num_dst, F] cotangent table using the precomputed ``dst_srcsort`` ids
# (= dst[perm_srcsort], static), then a SORTED segment-sum by src. Both
# directions of the incidence carry the needed aux (graph/incidence.py:
# edge_by_node / node).


def _spmm_fused_ok(d: Direction) -> bool:
    return (
        d.dst_srcsort is not None
        and d.src_sorted is not None
        and d.perm_srcsort is not None
    )


def _spmm_impl(meta, w, norm, src, dst):
    _, num_dst, has_norm, _ = meta
    msgs = fold_gather(w, src)
    if has_norm:
        msgs = msgs * norm[:, None].astype(msgs.dtype)
    return fold_segsum(msgs, dst, num_dst)


@functools.partial(jax.custom_vjp, nondiff_argnums=(0,))
def _spmm(meta, w, norm, src, dst, dst_srcsort, src_sorted, perm, mask):
    return _spmm_impl(meta, w, norm, src, dst)


def _spmm_fwd(meta, w, norm, src, dst, dst_srcsort, src_sorted, perm, mask):
    out = _spmm_impl(meta, w, norm, src, dst)
    norm_grad = meta[3]
    res = (
        w if norm_grad else None,
        norm,
        src,
        dst,
        dst_srcsort,
        src_sorted,
        perm,
        mask if norm_grad else None,
        jnp.zeros((0,), w.dtype),
    )
    return out, res


def _spmm_bwd(meta, res, g):
    num_src, _, has_norm, norm_grad = meta
    w, norm, src, dst, dst_srcsort, src_sorted, perm, mask, dtok = res

    gb = g.astype(dtok.dtype)  # bf16 mode: halves the gather traffic below
    rows = fold_gather(gb, dst_srcsort)
    if has_norm:
        norm_ss = fold_gather(norm, perm)
        rows = rows * norm_ss[:, None].astype(rows.dtype)
    dw = fold_segsum(rows, src_sorted, num_src).astype(dtok.dtype)

    dnorm = None
    if norm_grad:
        # SDDMM: dnorm_i = g[dst_i] . w[src_i]  (execution order); padded
        # entries clip-gather garbage rows — mask them so dnorm is exactly
        # zero at padding regardless of downstream norm factors
        gd = fold_gather(gb, dst).astype(jnp.float32)
        ws = fold_gather(w, src).astype(jnp.float32)
        dnorm = jnp.sum(gd * ws, axis=-1)
        dnorm = (dnorm * mask.astype(jnp.float32)).astype(norm.dtype)
    return (dw, dnorm, None, None, None, None, None, None)


_spmm.defvjp(_spmm_fwd, _spmm_bwd)


def _core_reduce(w: Array, d: Direction, norm, reduce: str, norm_grad: bool) -> Array:
    """Reduce over the entries this Direction covers ('add'/'max' only;
    'mean' is composed by the caller). Fused when the aux allows.

    Directions carrying bucket aux (built only for an explicit
    ``bucket_rows``) route through the table-sliced path
    (ops/bucketed.py) — except under norm gradients (LearnMask), whose
    SDDMM needs the unbucketed fused spmm."""
    if (
        reduce == "add"
        and w.shape[0] == d.num_src
        and getattr(d, "bucketed", None) is not None
        and not (norm is not None and norm_grad)
    ):
        from allset_tpu.ops.bucketed import bucketed_spmm

        n = jax.lax.stop_gradient(norm) if norm is not None else None
        if n is not None and d.canon_perm is not None:
            n = fold_gather(n, d.canon_perm)  # execution -> canonical order
        return bucketed_spmm(w, d.bucketed, n)
    if (
        reduce == "max"
        or w.shape[0] != d.num_src
        or not _spmm_fused_ok(d)
    ):
        msgs = dir_gather(w, d)
        if norm is not None:
            msgs = msgs * norm[:, None].astype(msgs.dtype)
        return dir_reduce(msgs, d, reduce)

    has_norm = norm is not None
    meta = (d.num_src, d.num_dst, has_norm, has_norm and norm_grad)
    if has_norm and not norm_grad:
        norm = jax.lax.stop_gradient(norm)
    narg = norm if has_norm else jnp.zeros((0,), jnp.float32)
    return _spmm(
        meta,
        w,
        narg,
        d.src,
        d.dst,
        d.dst_srcsort,
        d.src_sorted,
        d.perm_srcsort,
        d.mask,
    )


def dir_spmm(
    w: Array,
    d: Direction,
    norm: Array | None = None,
    reduce: str = "add",
    norm_grad: bool = False,
) -> Array:
    """Fused gather->scale->segment-reduce over a Direction. The result
    dtype follows ``w`` on the sorted path (bf16 in -> bf16 out; float32
    accumulation internally); unsorted fallbacks return float32.

    The backward never permutes [nnz, F] data (see module docstring).
    ``norm_grad`` must be True when ``norm`` requires gradients (LearnMask);
    otherwise norm's cotangent is declared zero (stop_gradient semantics).
    'mean' divides the fused sum by the static per-destination counts.
    'max' and aux-less Directions fall back to the composable path.

    Under vmap (vmapped statistical runs) every gather and reduce FOLDS
    the mapped axis into the row width — one pass serves all runs
    (ops/fold.py).

    Self-loop split Directions (``d.sl_mode``): the sparse core covers only
    the real edges; singleton self-loop edges contribute dense row copies —
    'append' concatenates w[sl_node]*sl_norm rows after the core output
    (V2E), 'add' adds the tail rows of w to destinations sl_node (E2V).

    A parallel.sharded.ShardedDirection dispatches to the shard_map
    edge-partitioned path (norms baked into the shard arrays).
    """
    if getattr(d, "mesh", None) is not None:  # ShardedDirection
        # vmapped runs over a ShardedExchange are gated structurally in
        # Trainer.fit (shard_map has no runs-folding batching rule)
        from allset_tpu.parallel.sharded import sharded_spmm

        # LearnMask: the traced norm travels on the Direction in canonical
        # order (per-shard norms are baked arrays). It applies ONLY when
        # the caller asked for a weighted reduce — PMA's attention
        # aggregation passes norm=None and must stay unweighted.
        traced = getattr(d, "norm_canon", None) if norm is not None else None
        if norm is not None and norm_grad and traced is None:
            raise NotImplementedError(
                "norm gradients through a ShardedDirection require the "
                "traced norm on d.norm_canon (set by ShardedExchange); "
                "refusing to silently drop the gradient"
            )
        out = sharded_spmm(
            w, d,
            use_norm=norm is not None and traced is None,
            reduce="max" if reduce == "max" else "add",
            norm=traced,
            norm_grad=norm_grad and traced is not None,
        )
        if reduce == "mean":
            out = out / jnp.maximum(d.dst_count, 1.0)[:, None].astype(out.dtype)
        return out

    core_reduce = "max" if reduce == "max" else "add"

    if d.sl_mode == "none":
        out = _core_reduce(w, d, norm, core_reduce, norm_grad)
        total = d.num_dst
    elif d.sl_mode == "append":
        # N-slot layout: one self-loop slot per node, identity rows.
        core = _core_reduce(w, d, norm, core_reduce, norm_grad)
        rows = w.astype(core.dtype)
        if norm is not None:  # norm=None means unweighted (PMA) everywhere
            rows = rows * d.sl_norm[:, None].astype(rows.dtype)
        out = jnp.concatenate([core, rows], axis=0)
        total = d.num_dst_total
    elif d.sl_mode == "add":
        core = _core_reduce(w[: d.num_src], d, norm, core_reduce, norm_grad)
        rows = w[d.num_src :].astype(core.dtype)
        # scale weights the self-loop entries AND zeroes the hole rows
        scale = d.sl_norm if norm is not None else d.sl_mask
        rows = rows * scale[:, None].astype(rows.dtype)
        if reduce == "max":
            # holes (zeroed rows) must not clamp negative maxima to 0
            out = jnp.where(
                d.sl_mask[:, None] > 0, jnp.maximum(core, rows), core
            )
        else:
            out = core + rows
        total = d.num_dst_total
    else:
        raise ValueError(f"unknown sl_mode {d.sl_mode!r}")

    if reduce == "mean":
        if d.dst_count is not None:
            cnt = d.dst_count
        else:
            cnt = jax.ops.segment_sum(
                d.mask.astype(jnp.float32),
                d.dst,
                num_segments=total,
                indices_are_sorted=d.dst_is_sorted,
            )
        out = out / jnp.maximum(cnt, 1.0)[:, None].astype(out.dtype)
    return out
