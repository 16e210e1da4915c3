"""Row-bucketed exchange (ops/bucketed.py): table-sliced gathers
must match the unbucketed fused spmm exactly — outputs AND gradients —
including under vmap (runs folding) and with the self-loop split."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from allset_tpu.graph.incidence import Incidence
from allset_tpu.ops.exchange import dir_spmm


def _inc(rng, num_nodes=50, num_edges=30, nnz=200, bucket_rows=0):
    node = rng.integers(0, num_nodes, nnz).astype(np.int32)
    edge = rng.integers(0, num_edges, nnz).astype(np.int32)
    norm = rng.normal(size=nnz).astype(np.float32)
    return Incidence.from_arrays(
        node, edge, norm=norm, num_nodes=num_nodes, num_edges=num_edges,
        bucket_rows=bucket_rows,
    )


@pytest.mark.parametrize("direction", ["v2e", "e2v"])
def test_bucketed_matches_unbucketed(rng, direction):
    plain = _inc(rng)
    buck = _inc(np.random.default_rng(0), bucket_rows=16)  # many buckets
    assert buck.bucket_by_node is not None and len(buck.bucket_by_node) == 4
    rng2 = np.random.default_rng(1)

    for inc in ():
        pass
    d_p = getattr(plain, direction)()
    d_b = getattr(buck, direction)()
    assert d_b.bucketed is not None
    rows = d_p.num_src
    w = jnp.asarray(rng2.normal(size=(rows, 8)).astype(np.float32))

    def f_p(w):
        return dir_spmm(w, d_p, norm=d_p.norm)

    def f_b(w):
        return dir_spmm(w, d_b, norm=d_b.norm)

    out_p, out_b = f_p(w), f_b(w)
    np.testing.assert_allclose(np.asarray(out_b), np.asarray(out_p),
                               rtol=1e-5, atol=1e-5)
    g = jnp.asarray(rng2.normal(size=out_p.shape).astype(np.float32))
    gp = jax.grad(lambda w: (f_p(w) * g).sum())(w)
    gb = jax.grad(lambda w: (f_b(w) * g).sum())(w)
    np.testing.assert_allclose(np.asarray(gb), np.asarray(gp),
                               rtol=1e-5, atol=1e-5)


def test_bucketed_no_norm_and_vmap(rng):
    buck = _inc(np.random.default_rng(0), bucket_rows=16)
    d = buck.v2e()
    rng2 = np.random.default_rng(2)
    ws = jnp.asarray(rng2.normal(size=(3, d.num_src, 8)).astype(np.float32))

    def f(w):
        return dir_spmm(w, d)  # norm=None (PMA form)

    out_v = jax.vmap(f)(ws)
    out_s = jnp.stack([f(ws[i]) for i in range(3)])
    np.testing.assert_allclose(np.asarray(out_v), np.asarray(out_s),
                               rtol=1e-5, atol=1e-5)
    # grads under vmap
    gv = jax.vmap(jax.grad(lambda w: (f(w) ** 2).sum()))(ws)
    gs = jnp.stack([jax.grad(lambda w: (f(w) ** 2).sum())(ws[i]) for i in range(3)])
    np.testing.assert_allclose(np.asarray(gv), np.asarray(gs),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.slow
def test_bucketed_setgnn_e2e(rng):
    """Full SetGNN fwd+bwd identical with and without bucket aux (incl.
    the self-loop split composition)."""
    from tests.conftest import make_random_hyperdata
    from allset_tpu.graph import add_self_loops, norm_construction
    from allset_tpu.graph.batch import Batch
    from allset_tpu.models import SetGNN, SetGNNConfig

    hd = norm_construction(add_self_loops(make_random_hyperdata(rng)), "all_one")
    b_plain = Batch.from_hyperdata(hd, bucket=128)
    b_buck = Batch.from_hyperdata(hd, bucket=128, bucket_rows=16)
    inc = b_buck.inc.real if b_buck.inc.real is not None else b_buck.inc
    assert inc.bucket_by_node is not None

    cfg = SetGNNConfig(
        num_features=hd.num_features, num_classes=hd.num_classes,
        all_num_layers=1, mlp_hidden=32, classifier_hidden=32,
        classifier_num_layers=1, heads=4, dropout=0.0,
    )
    model = SetGNN(cfg)
    v = model.init({"params": jax.random.PRNGKey(0)}, b_plain, False)

    def loss(v, b):
        return (model.apply(v, b, False) ** 2).sum()

    lp, gp = jax.value_and_grad(loss)(v, b_plain)
    lb, gb = jax.value_and_grad(loss)(v, b_buck)
    np.testing.assert_allclose(float(lb), float(lp), rtol=1e-5)
    for a, b in zip(jax.tree_util.tree_leaves(gp), jax.tree_util.tree_leaves(gb)):
        np.testing.assert_allclose(np.asarray(b), np.asarray(a),
                                   rtol=1e-4, atol=1e-5)
