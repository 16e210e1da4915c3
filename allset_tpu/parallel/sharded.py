"""Explicit edge-partitioned sharded exchange: shard_map + collectives.

The GSPMD path (``parallel/mesh.py``) lets XLA infer the partitioning.
This module is the hand-laid-out version SURVEY.md §7.7 calls for — the
distributed analog of sequence parallelism, built so every per-device
reduce stays SORTED:

  * the destination id space is cut into ``D`` equal row blocks; each
    shard owns the incidence entries whose dst falls in its block
    (entries are dst-sorted, so a shard's entries are one contiguous
    slice — segments NEVER straddle shards and the exchange itself needs
    **no input communication**: each device gathers from the replicated
    source table and sorted-segment-reduces into its own output rows.
    The only forward collective is the output reassembly — the sharded
    [num_dst/D, F] blocks replicate for the next exchange's gather as
    ONE explicit ALL-GATHER (left implicit, GSPMD replicates them as a
    zero-padded all-reduce at 2x the wire bytes). That is the minimum:
    new destination states must reach every device that will gather them;
  * the backward computes per-shard partial ``dw`` (sorted reduce over
    the shard's entries grouped by src) and combines with ONE
    ``psum`` over the edge axis — the only backward collective. No
    all-to-all, no collective-permute, no halo exchange
    anywhere; tests/test_parallel.py::test_sharded_step_collective_census
    asserts this census on the compiled HLO;
  * self-loop slots (N-slot layout, see graph/incidence.py) stay dense
    and replicated, outside the shard_map.

Partitioning is **segment-aware**: when equal row blocks would skew the
per-shard entry counts (power-law degree distributions — SURVEY.md §7
"hard parts" names walmart/yelp), the cut points move to the segment
boundaries nearest the entry-balanced positions. Shards then own
VARIABLE dst row ranges padded to one uniform block size; a static
reassembly gather (``reasm``) puts the stacked shard outputs back in
global row order, and the backward distributes the cotangent into the
padded blocks with the inverse map (``dist_idx``) — two extra
[num_dst]-row gathers, paid only when row blocks actually skew
(``balance_threshold``). Segments still never straddle shards, so every
per-shard reduce stays sorted and the forward stays collective-free.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from allset_tpu.graph import native
from allset_tpu.graph.incidence import Incidence, pad_bucket
from allset_tpu.ops.fold import fold_segsum

Array = jax.Array


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class ShardedDirection:
    """One direction of the bipartite exchange, pre-partitioned into D
    shards (leading axis D on every array; sharded over the mesh's edge
    axis at dispatch). Mirrors graph.incidence.Direction's sl fields."""

    src: Array  # i32[D, nnz_pad] global gather row ids (dst-sorted order)
    dst_local: Array  # i32[D, nnz_pad] dst - d*rows_per_shard (OOB at pad)
    norm: Array  # f32[D, nnz_pad]
    src_sorted: Array  # i32[D, nnz_pad] src ids sorted within shard
    dst_srcsort_local: Array  # i32[D, nnz_pad] dst_local in src-sorted order
    norm_srcsort: Array  # f32[D, nnz_pad]
    # canonical entry positions (index into the [nnz_pad] canonical-order
    # entry arrays of the source incidence) for TRACED per-entry norms
    # (LearnMask): shard exec order and shard src-sorted order. Padded
    # shard entries carry nnz_pad_canon (clip-gathers the zero-norm
    # canonical padding row; dropped by the dnorm scatter).
    perm_canon: Array  # i32[D, nnz_pad]
    perm_canon_srcsort: Array  # i32[D, nnz_pad]
    nnz_pad_canon: int = dataclasses.field(metadata=dict(static=True))
    sl_mask: Optional[Array]  # f32[num_nodes] (replicated)
    sl_norm: Optional[Array]  # f32[num_nodes]
    dst_count: Optional[Array]  # f32[num_dst_total] full degrees ('mean')
    num_src: int = dataclasses.field(metadata=dict(static=True))
    num_dst: int = dataclasses.field(metadata=dict(static=True))
    num_dst_padded: int = dataclasses.field(metadata=dict(static=True))
    rows_per_shard: int = dataclasses.field(metadata=dict(static=True))
    sl_mode: str = dataclasses.field(metadata=dict(static=True))
    num_dst_total: int = dataclasses.field(metadata=dict(static=True))
    mesh: Mesh = dataclasses.field(metadata=dict(static=True))
    axis: str = dataclasses.field(metadata=dict(static=True))
    # segment-aware balanced partition (None = equal row blocks): global
    # row -> position in the stacked shard outputs, and shard-local row ->
    # global row (clipped), for the fwd reassembly / bwd distribution
    reasm: Optional[Array] = None  # i32[num_dst]
    dist_idx: Optional[Array] = None  # i32[D, rows_per_shard]
    # optional TRACED per-entry norm in canonical order (set via
    # dataclasses.replace by the model, e.g. SetGNN LearnMask); when
    # present it overrides the baked norms in dir_spmm dispatch
    norm_canon: Optional[Array] = None

    @property
    def num_shards(self) -> int:
        return self.src.shape[0]


def _equal_rows(num_dst: int, D: int) -> int:
    """Rows per shard of the equal-row-block partition."""
    return max(1, -(-num_dst // D))


def shard_entry_counts(dst: np.ndarray, num_dst: int, D: int,
                       balance_threshold: float = 1.25):
    """Per-shard entry counts for equal row blocks vs segment-aware
    balanced cuts on a dst-sorted entry stream. Returns
    (counts_equal, counts_balanced, row_cuts_balanced) — the balance
    diagnostic surfaced by data.statistics.dataset_statistics."""
    rows = _equal_rows(num_dst, D)
    cuts_eq = np.searchsorted(dst, np.arange(D + 1) * rows)
    bal = _balanced_cuts(dst, num_dst, D, balance_threshold)
    if bal is None:
        return np.diff(cuts_eq), np.diff(cuts_eq), None
    cuts_e, row_cuts, _ = bal
    return np.diff(cuts_eq), np.diff(cuts_e), row_cuts


def _balanced_cuts(dst: np.ndarray, num_dst: int, D: int, threshold: float):
    """Entry-balanced, segment-aligned dst row cuts.

    Returns None when equal row blocks are already within ``threshold``
    of perfect balance (the reassembly gathers then cost nothing), else
    (entry_cuts [D+1], row_cuts [D+1], rows_uniform). Cuts snap to the
    segment boundary nearest each entry-balance target, so segments
    never straddle shards and per-shard reduces stay sorted."""
    nnz = len(dst)
    if nnz == 0 or D <= 1:
        return None
    rows_eq = _equal_rows(num_dst, D)
    cuts_eq = np.searchsorted(dst, np.arange(D + 1) * rows_eq)
    if np.diff(cuts_eq).max() <= threshold * nnz / D:
        return None
    # entry positions where a new segment begins
    starts = np.flatnonzero(np.diff(dst)) + 1
    starts = np.concatenate([[0], starts, [nnz]]).astype(np.int64)
    # adaptive greedy: each cut re-targets an equal share of the REMAINING
    # entries over the remaining shards (a giant segment absorbed by one
    # shard then no longer skews every later target), snapped to the
    # nearest segment boundary at or after the previous cut
    cuts_e = np.zeros(D + 1, np.int64)
    cuts_e[D] = nnz
    c = 0
    for d in range(1, D):
        target = c + (nnz - c) / (D - d + 1)
        i = np.searchsorted(starts, target)
        lo = starts[max(i - 1, 0)]
        hi = starts[min(i, len(starts) - 1)]
        pick = lo if (lo >= c and target - lo <= hi - target) else hi
        c = max(c, int(pick))
        cuts_e[d] = c
    row_cuts = np.empty(D + 1, np.int64)
    row_cuts[0] = 0
    row_cuts[D] = num_dst
    for d in range(1, D):
        c = cuts_e[d]
        row_cuts[d] = int(dst[c]) if c < nnz else num_dst
    row_cuts = np.maximum.accumulate(row_cuts)
    return cuts_e, row_cuts, max(int(np.diff(row_cuts).max()), 1)


def _build_one(dst, src, norm, canon_pos, nnz_pad_canon, num_src, num_dst,
               D, balance_threshold=1.25):
    """Host-side partition of one direction (entries dst-sorted).
    ``canon_pos[i]`` is entry i's position in the source incidence's
    canonical entry order (for traced per-entry norms). Cuts move to the
    segment boundaries nearest the entry-balance targets when equal row
    blocks would skew past ``balance_threshold`` (power-law graphs); the
    extra (reasm, dist_idx) maps are None on the equal-block path."""
    nnz = len(dst)
    bal = _balanced_cuts(dst, num_dst, D, balance_threshold)
    if bal is None:
        rows = _equal_rows(num_dst, D)
        cuts = np.searchsorted(dst, np.arange(D + 1) * rows).astype(np.int64)
        row_cuts = np.minimum(np.arange(D + 1) * rows, num_dst)
        reasm = dist_idx = None
    else:
        cuts, row_cuts, rows = bal
        reasm = np.empty(max(num_dst, 1), np.int32)
        dist_idx = np.empty((D, rows), np.int32)
        for d in range(D):
            a, b = int(row_cuts[d]), int(row_cuts[d + 1])
            reasm[a:b] = d * rows + np.arange(b - a, dtype=np.int32)
            # padded block rows carry the SENTINEL num_dst (not a clipped
            # duplicate of a real row): consumers append one zero row so
            # padded rows read zeros
            idx = a + np.arange(rows)
            dist_idx[d] = np.where(idx < b, idx, num_dst).astype(np.int32)
    num_dst_padded = rows * D
    max_e = int((cuts[1:] - cuts[:-1]).max()) if nnz else 0
    nnz_pad = pad_bucket(max(max_e, 1))

    S = dict(
        src=np.full((D, nnz_pad), num_src, np.int32),
        dst_local=np.full((D, nnz_pad), rows, np.int32),
        norm=np.zeros((D, nnz_pad), np.float32),
        src_sorted=np.full((D, nnz_pad), num_src, np.int32),
        dst_srcsort_local=np.full((D, nnz_pad), rows, np.int32),
        norm_srcsort=np.zeros((D, nnz_pad), np.float32),
        perm_canon=np.full((D, nnz_pad), nnz_pad_canon, np.int32),
        perm_canon_srcsort=np.full((D, nnz_pad), nnz_pad_canon, np.int32),
    )
    for d in range(D):
        lo, hi = int(cuts[d]), int(cuts[d + 1])
        k = hi - lo
        sdst = dst[lo:hi] - int(row_cuts[d])
        ssrc = src[lo:hi]
        snorm = norm[lo:hi]
        spos = canon_pos[lo:hi]
        S["src"][d, :k] = ssrc
        S["dst_local"][d, :k] = sdst
        S["norm"][d, :k] = snorm
        S["perm_canon"][d, :k] = spos
        order = native.stable_argsort(ssrc, num_src + 1)
        S["src_sorted"][d, :k] = ssrc[order]
        S["dst_srcsort_local"][d, :k] = sdst[order]
        S["norm_srcsort"][d, :k] = snorm[order]
        S["perm_canon_srcsort"][d, :k] = spos[order]
    if reasm is not None:
        S["reasm"] = reasm
        S["dist_idx"] = dist_idx
    return S, rows, num_dst_padded


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class ShardedExchange:
    """Both directions of the exchange, ready for dir_spmm dispatch."""

    v2e: ShardedDirection
    e2v: ShardedDirection

    @classmethod
    def build(cls, inc: Incidence, mesh: Mesh, axis: str = "edge",
              split: bool | None = None,
              balance_threshold: float = 1.25) -> "ShardedExchange":
        """Partition ``inc`` (its real sub-incidence when the self-loop
        split is available) over the mesh's ``axis``. ``split=False``
        forces the FULL incidence — required for traced per-entry norms
        (LearnMask), whose canonical entry indexing covers self-loop
        entries too. ``balance_threshold``: max tolerated per-shard entry
        skew before cuts move to entry-balanced segment boundaries
        (``inf`` forces equal row blocks)."""
        D = int(mesh.shape[axis])
        if split is None:
            split = inc.real is not None
        core = inc.real if split else inc

        n = np.asarray(core.node[: core.nnz])
        e = np.asarray(core.edge[: core.nnz])
        w = np.asarray(core.norm[: core.nnz])
        canon = np.arange(core.nnz, dtype=np.int32)
        npadc = core.nnz_padded

        # V2E: entries already edge-sorted
        Sv, rows_v, mpad = _build_one(
            e, n, w, canon, npadc, core.num_nodes, core.num_edges, D,
            balance_threshold,
        )
        ecount = np.bincount(e, minlength=core.num_edges).astype(np.float32)
        ncount = np.bincount(n, minlength=core.num_nodes).astype(np.float32)
        if split:
            ecount_total = np.concatenate([ecount, np.asarray(inc.sl_mask)])
            ncount_total = np.asarray(inc.node_count)
        else:
            ecount_total, ncount_total = ecount, ncount

        dv = ShardedDirection(
            **{k: jnp.asarray(v) for k, v in Sv.items()},
            nnz_pad_canon=npadc,
            sl_mask=inc.sl_mask if split else None,
            sl_norm=inc.sl_norm_full if split else None,
            dst_count=jnp.asarray(ecount_total),
            num_src=core.num_nodes,
            num_dst=core.num_edges,
            num_dst_padded=mpad,
            rows_per_shard=rows_v,
            sl_mode="append" if split else "none",
            num_dst_total=(core.num_edges + inc.num_nodes) if split else core.num_edges,
            mesh=mesh,
            axis=axis,
        )

        # E2V: node-sorted entry order
        order = native.stable_argsort(n, core.num_nodes + 1)
        Se, rows_e, npad_dst = _build_one(
            n[order], e[order], w[order], canon[order], npadc,
            core.num_edges, core.num_nodes, D, balance_threshold,
        )
        de = ShardedDirection(
            **{k: jnp.asarray(v) for k, v in Se.items()},
            nnz_pad_canon=npadc,
            sl_mask=inc.sl_mask if split else None,
            sl_norm=inc.sl_norm_full if split else None,
            dst_count=jnp.asarray(ncount_total),
            num_src=core.num_edges,
            num_dst=core.num_nodes,
            num_dst_padded=npad_dst,
            rows_per_shard=rows_e,
            sl_mode="add" if split else "none",
            num_dst_total=core.num_nodes,
            mesh=mesh,
            axis=axis,
        )
        return cls(v2e=dv, e2v=de)

    def shard(self) -> "ShardedExchange":
        """Place the per-shard arrays on the mesh (axis 0 sharded)."""
        from jax.sharding import NamedSharding

        def place(d: ShardedDirection) -> ShardedDirection:
            sh = NamedSharding(d.mesh, P(d.axis))
            rep = NamedSharding(d.mesh, P())
            kw = {}
            for f in (
                "src", "dst_local", "norm", "src_sorted",
                "dst_srcsort_local", "norm_srcsort",
                "perm_canon", "perm_canon_srcsort",
            ):
                kw[f] = jax.device_put(getattr(d, f), sh)
            for f in ("dist_idx",):
                v = getattr(d, f)
                kw[f] = jax.device_put(v, sh) if v is not None else None
            for f in ("sl_mask", "sl_norm", "dst_count", "reasm"):
                v = getattr(d, f)
                kw[f] = jax.device_put(v, rep) if v is not None else None
            return dataclasses.replace(d, **kw)

        return ShardedExchange(v2e=place(self.v2e), e2v=place(self.e2v))


# --- the sharded spmm ------------------------------------------------------
#
# meta = (rows_per_shard, num_src, norm_mode,
#         (num_dst, num_dst_padded, mesh), axis, norm_grad)
# norm_mode: 0 = unweighted (PMA), 1 = baked static norms,
#            2 = traced norms (canonical entry order; LearnMask-capable)


def _traced_norm(norm_c, perm):
    """Per-entry traced weights for one shard: padded shard entries index
    the canonical padding row (clip), whose norm must be 0 upstream."""
    return jnp.take(norm_c, jnp.minimum(perm[0], norm_c.shape[0] - 1), axis=0)


def _local_fwd(meta, w, norm_c, src, dst_local, norm, perm):
    rows_per_shard, _, norm_mode, _, axis, _ = meta
    msgs = jnp.take(w, src[0], axis=0, mode="clip")
    if norm_mode:
        n = norm[0] if norm_mode == 1 else _traced_norm(norm_c, perm)
        msgs = msgs * n[:, None].astype(msgs.dtype)
    part = fold_segsum(msgs, dst_local[0], rows_per_shard)
    # EXPLICIT all-gather: shards own disjoint dst row blocks, so
    # reassembly is concatenation. Leaving the output P(axis)-sharded lets
    # GSPMD replicate it as a zero-padded ALL-REDUCE — 2x the wire bytes
    # of the all-gather this logically is (ring: B(D-1)/D vs 2B(D-1)/D
    # per device); the collective census pins the all-gather structurally.
    return jax.lax.all_gather(part, axis, axis=0, tiled=True)


def _local_bwd(meta, g_shard, norm_c, w, dst_srcsort_local, src_sorted,
               norm_ss, perm_ss, src, dst_local, perm):
    _, num_src, norm_mode, _, axis, norm_grad = meta
    rows = jnp.take(g_shard, dst_srcsort_local[0], axis=0, mode="clip")
    if norm_mode:
        nss = norm_ss[0] if norm_mode == 1 else _traced_norm(norm_c, perm_ss)
        rows = rows * nss[:, None].astype(rows.dtype)
    part = fold_segsum(rows, src_sorted[0], num_src)
    dw = jax.lax.psum(part, axis)
    if not norm_grad:
        return dw, jnp.zeros((1,), jnp.float32)
    # SDDMM in shard exec order: dnorm_i = g[dst_i] . w[src_i], scattered
    # back to canonical entry positions (padded shard entries carry an
    # out-of-range index and drop), then combined across shards
    gd = jnp.take(g_shard, dst_local[0], axis=0, mode="clip").astype(jnp.float32)
    ws = jnp.take(w, src[0], axis=0, mode="clip").astype(jnp.float32)
    dn_local = jnp.sum(gd * ws, axis=-1)
    dnorm = jnp.zeros((norm_c.shape[0],), jnp.float32).at[perm[0]].add(
        dn_local, mode="drop"
    )
    return dw, jax.lax.psum(dnorm, axis)


def _sharded_core_impl(meta, w, norm_c, sd):
    _, _, _, (num_dst, num_dst_padded, mesh), axis, _ = meta
    fwd = jax.shard_map(
        functools.partial(_local_fwd, meta),
        mesh=mesh,
        in_specs=(P(), P(), P(axis), P(axis), P(axis), P(axis)),
        out_specs=P(),  # replicated by the body's explicit all-gather
        check_vma=False,
    )
    out = fwd(w, norm_c, sd.src, sd.dst_local, sd.norm, sd.perm_canon)
    if sd.reasm is not None:  # balanced cuts: stacked blocks -> global rows
        return jnp.take(out, sd.reasm, axis=0, mode="clip")[:num_dst]
    return out[:num_dst]


@functools.partial(jax.custom_vjp, nondiff_argnums=(0,))
def _sharded_core(meta, w, norm_c, sd):
    return _sharded_core_impl(meta, w, norm_c, sd)


def _sharded_core_fwd(meta, w, norm_c, sd):
    out = _sharded_core_impl(meta, w, norm_c, sd)
    norm_grad = meta[5]
    res = (w if norm_grad else None, norm_c, sd, jnp.zeros((0,), w.dtype))
    return out, res


def _sharded_core_bwd(meta, res, g):
    w, norm_c, sd, dtok = res
    _, num_src, _, (num_dst, num_dst_padded, mesh), axis, norm_grad = meta
    # pin the incoming cotangent replicated: the shard_map below takes it
    # row-sharded, and without the pin GSPMD propagates that sharding back
    # into the dense backward upstream (data-parallel GEMMs whose weight
    # gradients then need extra all-reduces)
    from jax.sharding import NamedSharding

    gb = jax.lax.with_sharding_constraint(
        g.astype(dtok.dtype), NamedSharding(mesh, P())
    )
    if sd.dist_idx is not None:  # balanced cuts: global rows -> blocks
        # dist_idx pads with the sentinel num_dst -> the appended zero row
        gb = jnp.concatenate(
            [gb, jnp.zeros((1, gb.shape[1]), gb.dtype)], axis=0
        )
        gb = jnp.take(gb, sd.dist_idx.reshape(-1), axis=0, mode="clip")
    else:
        pad = num_dst_padded - num_dst
        if pad:
            gb = jnp.concatenate(
                [gb, jnp.zeros((pad, gb.shape[1]), gb.dtype)], axis=0
            )
    if w is None:
        w = jnp.zeros((num_src, gb.shape[1]), dtok.dtype)
    bwd = jax.shard_map(
        functools.partial(_local_bwd, meta),
        mesh=mesh,
        in_specs=(P(axis), P(), P(), P(axis), P(axis), P(axis),
                  P(axis), P(axis), P(axis), P(axis)),
        out_specs=(P(), P()),
        check_vma=False,
    )
    dw, dnorm = bwd(gb, norm_c, w, sd.dst_srcsort_local, sd.src_sorted,
                    sd.norm_srcsort, sd.perm_canon_srcsort, sd.src,
                    sd.dst_local, sd.perm_canon)
    return (dw.astype(dtok.dtype), dnorm if norm_grad else None, None)


_sharded_core.defvjp(_sharded_core_fwd, _sharded_core_bwd)


# --- sharded max ------------------------------------------------------------


def _local_max(meta_m, w, norm_c, src, dst_local, norm, perm):
    rows_per_shard, norm_mode = meta_m
    msgs = jnp.take(w, src[0], axis=0, mode="clip")
    if norm_mode:
        n = norm[0] if norm_mode == 1 else _traced_norm(norm_c, perm)
        msgs = msgs * n[:, None].astype(msgs.dtype)
    out = jax.ops.segment_max(
        msgs.astype(jnp.float32), dst_local[0], num_segments=rows_per_shard,
        indices_are_sorted=True,
    )
    # torch_scatter semantics: empty segments -> 0 (ops/segment.py)
    return jnp.where(jnp.isfinite(out), out, jnp.zeros_like(out))


def sharded_segment_max(w, sd, norm_mode, norm_c):
    """Per-destination max, edge-partitioned. Shards own disjoint dst row
    blocks, so the forward needs no collective; the backward (argmax
    routing) is served by differentiating this shard_map directly — the
    only cross-shard cotangent is the replicated ``w``, whose transpose
    shard_map psums itself (check_vma on)."""
    f = jax.shard_map(
        functools.partial(_local_max, (sd.rows_per_shard, norm_mode)),
        mesh=sd.mesh,
        in_specs=(P(), P(), P(sd.axis), P(sd.axis), P(sd.axis), P(sd.axis)),
        out_specs=P(sd.axis),
        check_vma=True,
    )
    out = f(w, norm_c, sd.src, sd.dst_local, sd.norm, sd.perm_canon)
    if sd.reasm is not None:
        # balanced cuts; jnp.take's transpose (scatter-add of the cotangent
        # into the stacked blocks) is exact — block rows are disjoint
        return jnp.take(out, sd.reasm, axis=0, mode="clip")[: sd.num_dst]
    return out[: sd.num_dst]


def sharded_comm_stats(shex: "ShardedExchange", width: int,
                       itemsize: int = 4, learn_mask: bool = False) -> dict:
    """Communication accounting for one fwd+bwd pass over both directions
    of an edge-partitioned exchange (the module docstring's claims,
    quantified; structurally enforced on the compiled HLO by
    tests/test_parallel.py::test_sharded_step_collective_census):

      * forward: ONE explicit output-reassembly ALL-GATHER per direction
        (``[D * rows_per_shard, width]`` stacked disjoint blocks — ring
        cost B(D-1)/D per device, half an all-reduce's wire bytes) — no
        input communication, segments never straddle shards;
      * backward: ONE psum (all-reduce, ring cost 2B(D-1)/D) per
        direction of the replicated-source cotangent
        ``dw [num_src, width]``, plus (LearnMask) one psum of the
        canonical-order ``dnorm [nnz_pad_canon]`` per direction.

    ``fwd_bytes``/``bwd_bytes`` are collective PAYLOAD bytes; multiply by
    the ring factors above for per-device wire traffic.
    """
    out = {"reassembly_fwd": 0, "psums_bwd": 0, "fwd_bytes": 0, "bwd_bytes": 0}
    for sd in (shex.v2e, shex.e2v):
        out["reassembly_fwd"] += 1
        out["fwd_bytes"] += sd.rows_per_shard * sd.num_shards * width * itemsize
        out["psums_bwd"] += 1
        out["bwd_bytes"] += sd.num_src * width * itemsize
        if learn_mask:
            out["psums_bwd"] += 1
            out["bwd_bytes"] += sd.nnz_pad_canon * 4
    return out


def sharded_spmm(
    w: Array,
    sd: ShardedDirection,
    use_norm: bool = True,
    reduce: str = "add",
    norm: Optional[Array] = None,
    norm_grad: bool = False,
) -> Array:
    """out[m] = sum_{i: dst_i = m} norm_i * w[src_i], edge-partitioned.

    Entry weights: ``norm=None, use_norm=False`` is the PMA path
    (unweighted, matching ops.exchange.dir_spmm's norm=None);
    ``use_norm=True`` without ``norm`` uses the static norms baked into
    the shard arrays; an explicit ``norm`` array (CANONICAL entry order
    of the partitioned incidence — build the exchange with split=False
    so self-loop entries are covered) is gathered per shard, and
    ``norm_grad=True`` adds the SDDMM pass whose gradient (LearnMask)
    comes back psum'd in canonical order. 'mean' is composed by the
    caller (divide by full counts); 'max' runs per-shard segment-max
    (disjoint dst blocks: no collective)."""
    norm_mode = 2 if norm is not None else (1 if use_norm else 0)
    norm_c = (
        norm if norm is not None
        else jnp.zeros((max(sd.nnz_pad_canon, 1),), jnp.float32)
    )
    if norm_mode == 2 and not norm_grad:
        norm_c = jax.lax.stop_gradient(norm_c)
    w_core = w[: sd.num_src] if sd.sl_mode == "add" else w
    if reduce == "max":
        core = sharded_segment_max(w_core, sd, norm_mode, norm_c).astype(w.dtype)
    else:
        meta = (
            sd.rows_per_shard,
            sd.num_src,
            norm_mode,
            (sd.num_dst, sd.num_dst_padded, sd.mesh),
            sd.axis,
            norm_grad,
        )
        core = _sharded_core(meta, w_core, norm_c, sd)
    if sd.sl_mode == "append":
        rows = w.astype(core.dtype)
        if norm_mode:
            rows = rows * sd.sl_norm[:, None].astype(core.dtype)
        return jnp.concatenate([core, rows], axis=0)
    if sd.sl_mode == "add":
        rows = w[sd.num_src :].astype(core.dtype)
        scale = sd.sl_norm if norm_mode else sd.sl_mask
        rows = rows * scale[:, None].astype(core.dtype)
        if reduce == "max":
            return jnp.where(sd.sl_mask[:, None] > 0,
                             jnp.maximum(core, rows), core)
        return core + rows
    return core
