"""Multi-host initialization and two-level (within / across host) meshes.

The reference has no distributed runtime at all (SURVEY.md §2.5); this is
the net-new layer. Design: processes join via
``jax.distributed.initialize``; a mesh is laid out so the edge-partition
axis stays within a host and only replicated/reduced traffic crosses
hosts; XLA owns the transport.

On a single host these helpers degrade to the local-device mesh, so all
code paths are exercised by the CPU-mesh tests.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

import jax
import numpy as np
from jax.sharding import Mesh

from allset_tpu.parallel.mesh import EDGE_AXIS


def initialize_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Join the jax distributed runtime. No-op on single-process runs.
    Pass all three arguments where the environment tells JAX nothing of
    the cluster."""
    if num_processes is not None and num_processes <= 1:
        return
    kwargs = {}
    if coordinator_address is not None:
        kwargs["coordinator_address"] = coordinator_address
    if num_processes is not None:
        kwargs["num_processes"] = num_processes
    if process_id is not None:
        kwargs["process_id"] = process_id
    jax.distributed.initialize(**kwargs)


def hybrid_mesh(
    host_axis: str = EDGE_AXIS,
    cross_axis: str = "replica",
    devices: Optional[Sequence[jax.Device]] = None,
) -> Mesh:
    """2-D (cross, host) mesh: incidence edge-partitioning within each
    host, data/replica parallelism across hosts.

    With one process this is a (1, n_local) mesh — identical program,
    exercised in tests. With several processes, uses
    ``jax.experimental.mesh_utils.create_hybrid_device_mesh`` so the
    edge-partition collectives (psum of segment partials) never cross
    hosts.
    """
    if devices is None:
        devices = jax.devices()
    n_proc = jax.process_count()
    if n_proc > 1:
        from jax.experimental import mesh_utils

        per_slice = len(devices) // n_proc
        dmesh = mesh_utils.create_hybrid_device_mesh(
            mesh_shape=(1, per_slice),
            dcn_mesh_shape=(n_proc, 1),
            devices=devices,
        )
    else:
        dmesh = np.asarray(devices).reshape(1, len(devices))
    return Mesh(dmesh, (cross_axis, host_axis))


def mesh_summary(mesh: Mesh) -> str:
    return (
        f"mesh axes={dict(zip(mesh.axis_names, mesh.devices.shape))} "
        f"devices={mesh.devices.size} processes={jax.process_count()}"
    )
