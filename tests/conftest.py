"""Test config: run on a virtual 8-device CPU mesh.

Multi-device sharding logic is identical code on a forced CPU mesh and on
several GPUs (SURVEY.md §4 item 4); chip_smoke.py --chips 4 runs the
edge-partitioned step on four cards.
"""

import os

# Must precede CPU backend init; jax may already be imported by the time
# this runs, so set the config explicitly as well as the env var.
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ["JAX_PLATFORMS"] = "cpu"

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np
import pytest


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def make_random_hyperdata(
    rng, num_nodes=50, num_hyperedges=20, avg_size=4, num_features=16, num_classes=3
):
    """Small random hypergraph for unit tests."""
    from allset_tpu.graph.transforms import HyperData, coalesce

    nodes = []
    edges = []
    for e in range(num_hyperedges):
        k = max(1, rng.poisson(avg_size))
        members = rng.choice(num_nodes, size=min(k, num_nodes), replace=False)
        nodes.extend(members.tolist())
        edges.extend([e] * len(members))
    node, edge = coalesce(np.array(nodes), np.array(edges))
    x = rng.normal(size=(num_nodes, num_features)).astype(np.float32)
    y = rng.integers(0, num_classes, size=num_nodes)
    return HyperData(
        x=x,
        y=y,
        node=node,
        edge=edge,
        num_nodes=num_nodes,
        num_hyperedges=num_hyperedges,
    )


@pytest.fixture
def hyperdata(rng):
    return make_random_hyperdata(rng)
