"""Batch: the device-side bundle every model consumes.

The reference threads a mutable PyG ``Data`` object through training
(``src/train.py:327-437``), with per-method fields monkey-patched on
(HNHN norm vectors, UniGNN degrees, dense G...). Here the same role is a
frozen pytree: features, labels, the incidence (or a clique-expanded
V2V graph reusing the same Incidence container with num_edges ==
num_nodes), and a dict of per-model extras.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np

from allset_tpu.graph.incidence import Incidence
from allset_tpu.graph.transforms import HyperData

Array = jax.Array


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Batch:
    x: Array  # [N, F]
    y: Array  # [N] int32
    inc: Optional[Incidence]
    extras: Dict[str, Array] = dataclasses.field(default_factory=dict)
    # explicit shard_map edge-partitioned exchange (parallel/sharded);
    # when set, SetGNN routes its sparse traffic through it
    shex: Optional[object] = None

    @property
    def num_nodes(self) -> int:
        return self.x.shape[0]

    @classmethod
    def from_hyperdata(
        cls, data: HyperData, bucket: int = 256, with_incidence: bool = True,
        bucket_rows: int = 0,
    ) -> "Batch":
        extras = {k: jnp.asarray(v) for k, v in data.extras.items()}
        return cls(
            x=jnp.asarray(data.x, dtype=jnp.float32),
            y=jnp.asarray(data.y, dtype=jnp.int32),
            inc=(
                data.to_incidence(bucket=bucket, bucket_rows=bucket_rows)
                if with_incidence
                else None
            ),
            extras=extras,
        )


def split_masks(split_idx: Dict[str, np.ndarray], num_nodes: int) -> Dict[str, Array]:
    """index arrays -> static-shape boolean masks (XLA-friendly: no dynamic
    gathers of variable-length index sets; masked reductions instead)."""
    out = {}
    for k, idx in split_idx.items():
        m = np.zeros(num_nodes, dtype=bool)
        m[np.asarray(idx)] = True
        out[k] = jnp.asarray(m)
    return out
