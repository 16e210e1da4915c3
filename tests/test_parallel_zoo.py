"""Multi-chip (GSPMD) parity for the whole model zoo.

Every factory method with an incidence must produce identical forward
outputs AND parameter gradients when its batch is edge-partitioned over
the 8-device CPU mesh (incidence nnz sharded, features/params
replicated — parallel/mesh.py). XLA inserts the partial-reduce + psum;
numerics must match single-device execution."""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from allset_tpu.data.synthetic import synthetic_hypergraph
from allset_tpu.parallel.mesh import make_mesh, replicate, shard_batch
from allset_tpu.train.factory import ExperimentConfig, prepare

pytestmark = pytest.mark.slow  # e2e / multi-device: see pytest.ini

# every METHODS entry that consumes an incidence (MLP is structure-free)
ZOO = (
    "AllSetTransformer",
    "AllDeepSets",
    "CEGCN",
    "CEGAT",
    "HyperGCN",
    "HGNN",
    "HNHN",
    "HCHA",
    "UniGCNII",
    "UniGNN",
)


@pytest.mark.parametrize("method", ZOO)
def test_zoo_gspmd_parity(method):
    hd = synthetic_hypergraph(num_nodes=96, num_hyperedges=40, seed=5)
    cfg = ExperimentConfig(
        method=method, all_num_layers=2, mlp_hidden=32,
        classifier_num_layers=1, classifier_hidden=32, heads=2,
        dropout=0.0, bucket=512,
    )
    model, batch, _ = prepare(cfg, hd)
    v = model.init({"params": jax.random.PRNGKey(0)}, batch, False)
    y = batch.y

    def loss(v, b):
        out = model.apply(v, b, False)
        logp = jax.nn.log_softmax(out)
        return -jnp.take_along_axis(logp, y[:, None], 1).mean()

    l_want, g_want = jax.value_and_grad(loss)(v, batch)

    mesh = make_mesh(8)
    sbatch = shard_batch(batch, mesh)
    sparams = replicate(v, mesh)
    with mesh:
        l_got, g_got = jax.jit(jax.value_and_grad(loss))(sparams, sbatch)
    np.testing.assert_allclose(float(l_got), float(l_want), rtol=1e-5)
    for a, b in zip(
        jax.tree_util.tree_leaves(g_want), jax.tree_util.tree_leaves(g_got)
    ):
        np.testing.assert_allclose(
            np.asarray(b), np.asarray(a), rtol=1e-4, atol=1e-5
        )
