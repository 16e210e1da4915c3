"""The Incidence pytree: static-shape sparse hypergraph for XLA.

The reference stores a hypergraph as a dynamic-length ``2 x nnz`` torch
LongTensor (star-expansion bipartite edge list, documented at reference
``src/load_other_datasets.py:122-125`` and consumed by ``SetGNN.forward``
at ``src/models.py:450-456``). That representation is re-designed here for
XLA's static-shape compilation model:

  * node ids and hyperedge ids live in **separate 0-based id spaces**
    (the reference offsets hyperedge ids by num_nodes and rebases them
    in-place every forward at ``src/models.py:453-454``; we do it once,
    on the host, at construction).
  * the nnz axis is **padded to a bucket** (multiple of 256 by default) so
    that adding self-loops / re-normalizing never triggers re-compilation.
  * padded entries carry ``node == num_nodes`` and ``edge == num_edges``
    (out-of-range, dropped by XLA scatter) and ``norm == 0``.
  * entries are canonically **sorted by hyperedge id** (the V2E segment
    axis); the E2V direction reuses the same entry order with roles
    swapped, so a learned per-entry mask (LearnMask,
    ``src/models.py:336-337,451-452``) is consistent across directions.

An Incidence is a pytree: it can be donated to jit, sharded with
``jax.sharding``, and carried through ``lax`` control flow.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

Array = jax.Array


def pad_bucket(n: int, bucket: int = 256) -> int:
    """Round nnz up to a bucket so shapes stay static across small edits."""
    if bucket <= 0:
        return n
    return max(bucket, ((n + bucket - 1) // bucket) * bucket)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Incidence:
    """Padded COO incidence of a hypergraph.

    node[i], edge[i] — the i-th (node, hyperedge) incidence entry, 0-based
    in their own id spaces. norm[i] — per-entry weight (``data.norm`` of the
    reference, ``src/preprocessing.py:451-464``); 0 at padded entries, so it
    doubles as the float mask. mask[i] — boolean validity.

    num_nodes / num_edges / nnz are static (not traced): python ints fixed
    at construction.
    """

    node: Array  # i32[nnz_pad]
    edge: Array  # i32[nnz_pad]
    norm: Array  # f32[nnz_pad]
    mask: Array  # bool[nnz_pad]
    num_nodes: int = dataclasses.field(metadata=dict(static=True))
    num_edges: int = dataclasses.field(metadata=dict(static=True))
    nnz: int = dataclasses.field(metadata=dict(static=True))
    # Node-sorted aux: a second entry ordering, sorted by node id, so the
    # E->V reduce (and the backward of every V-side gather) also runs as a
    # *sorted* segment-sum. node_perm maps canonical (edge-sorted) order ->
    # node-sorted order; inv_node_perm is its inverse. Padded entries carry
    # node == num_nodes and stable-sort to the tail in both orders.
    node_perm: Optional[Array] = None  # i32[nnz_pad]: canonical -> node-order
    inv_node_perm: Optional[Array] = None  # i32[nnz_pad]: node-order -> canonical
    node_sorted: Optional[Array] = None  # i32[nnz_pad] = node[node_perm]
    edge_by_node: Optional[Array] = None  # i32[nnz_pad] = edge[node_perm]
    # static per-destination valid-entry counts (degrees) for 'mean' reduces
    node_count: Optional[Array] = None  # f32[num_nodes]
    edge_count: Optional[Array] = None  # f32[num_edges]
    # Self-loop suffix split: when the LAST num_sl_edges hyperedges are
    # singleton self-loops (Add_Self_Loops appends one per node, reference
    # src/preprocessing.py:412-448), their V2E contribution is just a row
    # copy of the source table and their E2V contribution a row add — no
    # gather/scatter needed. `real` is a nested Incidence over the real
    # edges only (smaller nnz, smaller gather tables); sl_node[j] is the
    # node of self-loop edge (num_edges - num_sl_edges + j).
    #
    # The split execution uses an N-SLOT layout: the device-side edge
    # state table reserves one self-loop slot PER NODE (real.num_edges +
    # num_nodes rows), with "holes" at nodes the reference's skip rule
    # left without a self-loop. Append/add then become identity slices —
    # no 131K-row gather (fwd) or scatter-add (bwd) at all. sl_mask is
    # 1.0 at nodes with a self-loop, 0.0 at holes; sl_norm_full carries
    # the per-self-loop norm in node order (0 at holes).
    real: Optional["Incidence"] = None
    sl_node: Optional[Array] = None  # i32[num_sl_edges] (compact, node ids)
    sl_mask: Optional[Array] = None  # f32[num_nodes]
    sl_norm_full: Optional[Array] = None  # f32[num_nodes]
    num_sl_edges: int = dataclasses.field(default=0, metadata=dict(static=True))
    # Row-bucketed exchange (ops/bucketed.py): built only when the caller
    # passes bucket_rows > 0 and a gather-table side exceeds it.
    # by_node: entries grouped by node-id range, reduced by edge (serves
    # the V2E forward AND the E2V backward); by_edge: the transpose.
    bucket_by_node: Optional[tuple] = None  # tuple[BucketSide, ...]
    bucket_by_edge: Optional[tuple] = None

    @property
    def nnz_padded(self) -> int:
        return self.node.shape[0]

    @classmethod
    def from_arrays(
        cls,
        node: np.ndarray,
        edge: np.ndarray,
        norm: Optional[np.ndarray] = None,
        num_nodes: Optional[int] = None,
        num_edges: Optional[int] = None,
        bucket: int = 256,
        sort_by_edge: bool = True,
        num_sl_edges: int = 0,
        bucket_rows: int = 0,
    ) -> "Incidence":
        """Build from host-side numpy COO (unpadded, 0-based id spaces).

        With ``sort_by_edge`` the entries take the canonical edge-sorted
        order and the node-sorted second order is precomputed, so every
        reduce of the exchange runs sorted (ops/exchange.py)."""
        node = np.asarray(node, dtype=np.int32)
        edge = np.asarray(edge, dtype=np.int32)
        if node.shape != edge.shape or node.ndim != 1:
            raise ValueError("node/edge must be 1-D and equal length")
        nnz = int(node.shape[0])
        if num_nodes is None:
            num_nodes = int(node.max()) + 1 if nnz else 0
        if num_edges is None:
            num_edges = int(edge.max()) + 1 if nnz else 0
        if norm is None:
            norm = np.ones(nnz, dtype=np.float32)
        norm = np.asarray(norm, dtype=np.float32)

        if sort_by_edge and nnz:
            # stable sort: canonical segment order for the V2E direction
            # (native counting sort when built: O(nnz + M))
            from allset_tpu.graph import native

            order = native.stable_argsort(edge, int(num_edges) + 1)
            node, edge, norm = node[order], edge[order], norm[order]

        # self-loop suffix split (valid only in canonical order)
        sl_fields = dict(real=None, sl_node=None, sl_mask=None,
                         sl_norm_full=None, num_sl_edges=0)
        if num_sl_edges > 0 and sort_by_edge and nnz:
            boundary = int(num_edges) - num_sl_edges
            k = int(np.searchsorted(edge, boundary))
            tail_e, tail_n = edge[k:], node[k:]
            ok = (
                len(tail_e) == num_sl_edges
                and np.array_equal(
                    tail_e, np.arange(boundary, num_edges, dtype=tail_e.dtype)
                )
            )
            if ok:
                mask = np.zeros(num_nodes, np.float32)
                mask[tail_n] = 1.0
                norm_full = np.zeros(num_nodes, np.float32)
                norm_full[tail_n] = norm[k:]
                sl_fields = dict(
                    real=cls.from_arrays(
                        node[:k], edge[:k], norm=norm[:k],
                        num_nodes=num_nodes, num_edges=boundary,
                        bucket=bucket, sort_by_edge=True,
                        bucket_rows=bucket_rows,
                    ),
                    sl_node=jnp.asarray(tail_n.astype(np.int32)),
                    sl_mask=jnp.asarray(mask),
                    sl_norm_full=jnp.asarray(norm_full),
                    num_sl_edges=num_sl_edges,
                )

        npad = pad_bucket(nnz, bucket)
        pad = npad - nnz
        if pad:
            node = np.concatenate([node, np.full(pad, num_nodes, dtype=np.int32)])
            edge = np.concatenate([edge, np.full(pad, num_edges, dtype=np.int32)])
            norm = np.concatenate([norm, np.zeros(pad, dtype=np.float32)])
        mask = np.arange(npad) < nnz

        node_aux = dict(
            node_perm=None,
            inv_node_perm=None,
            node_sorted=None,
            edge_by_node=None,
            node_count=None,
            edge_count=None,
        )
        if sort_by_edge:
            # node-sorted second ordering (padded entries sort last: their
            # node id == num_nodes exceeds every valid id; stable sort)
            from allset_tpu.graph import native

            nperm = native.stable_argsort(node, int(num_nodes) + 1).astype(np.int32)
            inv = np.empty_like(nperm)
            inv[nperm] = np.arange(npad, dtype=np.int32)
            node_aux = dict(
                node_perm=jnp.asarray(nperm),
                inv_node_perm=jnp.asarray(inv),
                node_sorted=jnp.asarray(node[nperm]),
                edge_by_node=jnp.asarray(edge[nperm]),
                node_count=jnp.asarray(
                    np.bincount(node[:nnz], minlength=num_nodes).astype(np.float32)
                ),
                edge_count=jnp.asarray(
                    np.bincount(edge[:nnz], minlength=num_edges).astype(np.float32)
                ),
            )

        bucket_fields = dict(bucket_by_node=None, bucket_by_edge=None)
        if (
            sort_by_edge
            and bucket_rows > 0
            and nnz
            and (num_nodes > bucket_rows or num_edges > bucket_rows)
        ):
            # a gather table exceeds bucket_rows: build the bucketed
            # exchange aux (ops/bucketed.py) over the VALID entries
            from allset_tpu.ops.bucketed import build_bucket_side

            bucket_fields["bucket_by_node"] = build_bucket_side(
                node[:nnz], edge[:nnz], int(num_nodes), int(num_edges),
                bucket_rows,
            )
            bucket_fields["bucket_by_edge"] = build_bucket_side(
                edge[:nnz], node[:nnz], int(num_edges), int(num_nodes),
                bucket_rows,
            )

        return cls(
            node=jnp.asarray(node),
            edge=jnp.asarray(edge),
            norm=jnp.asarray(norm),
            mask=jnp.asarray(mask),
            num_nodes=int(num_nodes),
            num_edges=int(num_edges),
            nnz=nnz,
            **node_aux,
            **sl_fields,
            **bucket_fields,
        )

    def with_norm(self, norm: Array) -> "Incidence":
        """Replace the per-entry norm (e.g. LearnMask Importance * norm)."""
        return dataclasses.replace(self, norm=norm)

    # --- directed views (see Direction below) ---

    def _bucketed_dir(self, fwd_by_node: bool):
        if self.bucket_by_node is None:
            return None
        from allset_tpu.ops.bucketed import BucketedDir

        if fwd_by_node:
            return BucketedDir(fwd=self.bucket_by_node, bwd=self.bucket_by_edge)
        return BucketedDir(fwd=self.bucket_by_edge, bwd=self.bucket_by_node)

    def v2e(self, norm: Optional[Array] = None) -> "Direction":
        """V->E direction in the canonical (edge-sorted) entry order:
        gather node rows, reduce by hyperedge (sorted)."""
        return Direction(
            bucketed=self._bucketed_dir(fwd_by_node=True),
            src=self.node,
            dst=self.edge,
            norm=self.norm if norm is None else norm,
            mask=self.mask,
            dst_count=self.edge_count,
            src_sorted=self.node_sorted,
            perm_srcsort=self.node_perm,
            dst_srcsort=self.edge_by_node,
            num_src=self.num_nodes,
            num_dst=self.num_edges,
        )

    def e2v(self, norm: Optional[Array] = None) -> "Direction":
        """E->V direction executed in the node-sorted entry order: gather
        hyperedge rows, reduce by node (sorted). Per-entry inputs given in
        canonical order (norm) are permuted on the fly ([nnz] gather)."""
        if self.node_perm is None:
            # no node-sorted aux: fall back to canonical order (reduce by
            # node is then unsorted)
            return Direction(
                src=self.edge,
                dst=self.node,
                norm=self.norm if norm is None else norm,
                mask=self.mask,
                dst_count=self.node_count,
                src_sorted=None,
                perm_srcsort=None,
                dst_srcsort=None,
                num_src=self.num_edges,
                num_dst=self.num_nodes,
                dst_is_sorted=False,
            )
        n = self.norm if norm is None else norm
        return Direction(
            bucketed=self._bucketed_dir(fwd_by_node=False),
            canon_perm=self.inv_node_perm,
            src=self.edge_by_node,
            dst=self.node_sorted,
            norm=jnp.take(n, self.node_perm, axis=0),
            mask=jnp.take(self.mask, self.node_perm, axis=0),
            dst_count=self.node_count,
            src_sorted=self.edge,
            perm_srcsort=self.inv_node_perm,
            dst_srcsort=self.node,
            num_src=self.num_edges,
            num_dst=self.num_nodes,
        )

    # --- self-loop split directed views ---

    def v2e_split(self) -> "Direction":
        """V->E over the REAL edges only; dir_spmm appends one self-loop
        slot per node (identity rows) -> [real.num_edges + num_nodes, F].

        NOTE the N-slot layout: the output's tail num_nodes rows are the
        self-loop slots in NODE order, with junk at holes — a different
        (internal) edge indexing than this incidence's compact edge ids.
        Pair only with e2v_split, which consumes the same layout."""
        assert self.real is not None
        base = self.real.v2e()
        return dataclasses.replace(
            base,
            sl_mode="append",
            num_dst_total=self.real.num_edges + self.num_nodes,
            sl_mask=self.sl_mask,
            sl_norm=self.sl_norm_full,
            dst_count=jnp.concatenate([self.real.edge_count, self.sl_mask]),
        )

    def e2v_split(self) -> "Direction":
        """E->V over the REAL edges only; dir_spmm adds w's tail num_nodes
        rows (the per-node self-loop slots) masked at holes."""
        assert self.real is not None
        base = self.real.e2v()
        return dataclasses.replace(
            base,
            sl_mode="add",
            num_dst_total=self.num_nodes,
            sl_mask=self.sl_mask,
            sl_norm=self.sl_norm_full,
            dst_count=self.node_count,
        )

    # --- degree helpers (host-free, jittable) ---

    def node_degree(self) -> Array:
        """d_v: number of hyperedges each node sits in. [num_nodes]"""
        return jax.ops.segment_sum(
            self.norm_ones(), self.node, num_segments=self.num_nodes
        )

    def edge_degree(self) -> Array:
        """d_e: hyperedge cardinalities. [num_edges]"""
        return jax.ops.segment_sum(
            self.norm_ones(), self.edge, num_segments=self.num_edges,
            indices_are_sorted=True,
        )

    def norm_ones(self) -> Array:
        return self.mask.astype(jnp.float32)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Direction:
    """One directed half of the bipartite exchange, in a fixed execution
    entry order chosen so the reduce side is SORTED:

      * V->E rides the canonical edge-sorted order;
      * E->V rides the node-sorted second order (``Incidence.node_perm``).

    ``src``/``norm``/``mask`` are in execution order; ``dst`` is ascending.
    The gather's *backward* is a segment-sum over ``src`` — served sorted
    too, via ``perm_srcsort`` (execution order -> src-sorted order) and
    ``src_sorted``. Consumed by ``allset_tpu.ops.exchange``.

    Padding contract: padded entries carry out-of-range ids and zero
    norm/mask, and every model zeroes their message contribution, so their
    cotangents vanish — the sorted backward may therefore drop them.
    """

    src: Array  # i32[nnz_pad] gather row ids (execution order)
    dst: Array  # i32[nnz_pad] reduce segment ids (ascending)
    norm: Array  # f32[nnz_pad]
    mask: Array  # bool[nnz_pad]
    dst_count: Optional[Array]  # f32[num_dst] valid entries per segment
    src_sorted: Optional[Array]  # i32[nnz_pad] src ids, sorted (gather bwd)
    perm_srcsort: Optional[Array]  # i32[nnz_pad] exec -> src-sorted order
    # dst ids re-ordered into src-sorted entry order (= dst[perm_srcsort]);
    # lets the fused spmm backward read the output-cotangent rows directly
    # in src-sorted order — no [nnz, F] permute (ops/exchange.dir_spmm)
    dst_srcsort: Optional[Array]
    num_src: int = dataclasses.field(metadata=dict(static=True))
    num_dst: int = dataclasses.field(metadata=dict(static=True))
    dst_is_sorted: bool = dataclasses.field(default=True, metadata=dict(static=True))
    # Self-loop suffix handling in the N-SLOT layout (ops/exchange.dir_spmm):
    #   'none'   — this Direction covers all entries (default);
    #   'append' — V2E over the real edges only; the output appends ALL
    #              num_nodes source rows (one self-loop slot per node,
    #              singleton multisets are identity), scaled by
    #              sl_norm_full when a norm is in effect; holes carry
    #              junk rows that nothing consumes;
    #   'add'    — E2V over the real edges only; w's tail num_nodes rows
    #              are the self-loop slots, added to the output scaled by
    #              sl_norm_full (with norm) or sl_mask (unweighted — the
    #              mask zeroes hole rows).
    # dst_count (when set) is sized num_dst_total so 'mean' divides by the
    # FULL destination degree after the self-loop contribution.
    sl_mode: str = dataclasses.field(default="none", metadata=dict(static=True))
    num_dst_total: int = dataclasses.field(default=0, metadata=dict(static=True))
    sl_mask: Optional[Array] = None  # f32[num_nodes]
    sl_norm: Optional[Array] = None  # f32[num_nodes] (zero at holes)
    # row-bucketed aux (ops/bucketed.BucketedDir): when set,
    # dir_spmm's 'add' core routes through table-sliced gathers.
    # canon_perm maps THIS direction's execution order back to canonical
    # entry order (traced norms are canonicalized before bucket dispatch);
    # None = execution order IS canonical (V2E).
    bucketed: Optional[object] = None
    canon_perm: Optional[Array] = None

    @classmethod
    def plain(
        cls,
        src: Array,
        dst: Array,
        norm: Optional[Array] = None,
        mask: Optional[Array] = None,
        num_src: int = 0,
        num_dst: int = 0,
        dst_is_sorted: bool = False,
    ) -> "Direction":
        """Ad-hoc direction from raw COO arrays (no sorted aux)."""
        if norm is None:
            norm = jnp.ones(src.shape, jnp.float32)
        if mask is None:
            mask = jnp.ones(src.shape, bool)
        return cls(
            src=src,
            dst=dst,
            norm=norm,
            mask=mask,
            dst_count=None,
            src_sorted=None,
            perm_srcsort=None,
            dst_srcsort=None,
            num_src=num_src,
            num_dst=num_dst,
            dst_is_sorted=dst_is_sorted,
        )
