"""Quick fwd+bwd timing for zoo models at bench scale, on one GPU.

    python benchmarks/zoo_bench.py      # ZOO_ONLY=HCHA,HNHN  ZOO_DTYPE=float32
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp

from allset_tpu.utils.profiling import measurement_device


def scan_time(body, init, K=(8, 40), n=3):
    """Per-step time as the SLOPE between two scan lengths: the
    difference of two lengths cancels the fixed per-call launch cost."""
    k0, k1 = K

    def timed(k):
        @jax.jit
        def run(x):
            return jax.lax.scan(
                lambda c, _: (body(c), None), x, None, length=k
            )[0]

        jax.block_until_ready(run(init))
        best = 1e9
        for _ in range(n):
            t0 = time.perf_counter()
            jax.block_until_ready(run(init))
            best = min(best, time.perf_counter() - t0)
        return best

    return (timed(k1) - timed(k0)) / (k1 - k0)


def _want(name):
    """ZOO_ONLY=UniGCNII,HCHA runs only those legs."""
    only = os.environ.get("ZOO_ONLY")
    if only is None:
        return True
    return name in [s.strip() for s in only.split(",")]


def main():
    print(measurement_device())
    from allset_tpu.data.synthetic import scale_free_hypergraph
    from allset_tpu.graph import add_self_loops, norm_construction
    from allset_tpu.graph.batch import Batch
    from allset_tpu.graph.transforms import generate_norm_hnhn, unignn_degrees

    hd = scale_free_hypergraph(
        num_nodes=1 << 17, num_hyperedges=1 << 16, avg_edge_size=12,
        feature_dim=256, seed=0,
    )
    hd = norm_construction(add_self_loops(hd), "all_one")

    from allset_tpu.models.hcha import HCHA, HCHAConfig
    from allset_tpu.models.hnhn import HNHN, HNHNConfig
    from allset_tpu.models.unignn import UniGCNII, UniGCNIIConfig

    batch = Batch.from_hyperdata(hd, bucket=1024)
    nnz = batch.inc.nnz

    def fwd_bwd_time(model, batch):
        v = model.init({"params": jax.random.PRNGKey(0)}, batch, False)

        def body(p):
            g = jax.grad(
                lambda p: jnp.sum(model.apply(p, batch, False) ** 2)
            )(p)
            return jax.tree_util.tree_map(lambda a, b: a - 0.0 * b, p, g)

        return scan_time(body, v)

    dt = os.environ.get("ZOO_DTYPE", "bfloat16")
    if _want("HCHA"):
        cfg = HCHAConfig(num_features=256, num_classes=8, all_num_layers=2,
                         mlp_hidden=256, dtype=dt)
        t = fwd_bwd_time(HCHA(cfg), batch)
        print(f"HCHA      fwd+bwd: {t*1e3:7.2f} ms  ({nnz/t/1e6:6.2f} M edges/s)")

    if _want("HNHN"):
        hd2 = generate_norm_hnhn(hd, alpha=-1.5, beta=-0.5)
        b2 = Batch.from_hyperdata(hd2, bucket=1024)
        cfg = HNHNConfig(num_features=256, num_classes=8, all_num_layers=2,
                         mlp_hidden=256, dtype=dt)
        t = fwd_bwd_time(HNHN(cfg), b2)
        print(f"HNHN      fwd+bwd: {t*1e3:7.2f} ms  ({nnz/t/1e6:6.2f} M edges/s)")

    # UniGCNII's factory pipeline has no Add_Self_Loops (src/train.py:390-416)
    hd3 = scale_free_hypergraph(
        num_nodes=1 << 17, num_hyperedges=1 << 16, avg_edge_size=12,
        feature_dim=256, seed=0,
    )
    hd3 = norm_construction(hd3, "all_one")
    degV, degE = unignn_degrees(hd3)
    hd3.extras = dict(hd3.extras, degV=degV, degE=degE)
    b3 = Batch.from_hyperdata(hd3, bucket=1024)
    if _want("UniGCNII"):
        cfg = UniGCNIIConfig(num_features=256, num_classes=8, all_num_layers=2,
                             mlp_hidden=256, dtype=dt)
        t = fwd_bwd_time(UniGCNII(cfg), b3)
        print(f"UniGCNII  fwd+bwd: {t*1e3:7.2f} ms  ({b3.inc.nnz/t/1e6:6.2f} M edges/s)")

    # AllDeepSets: the reference's second flagship (PMA off, DeepSets
    # half-layers) on the same graph/pipeline as AllSetTransformer
    from allset_tpu.models import SetGNN, SetGNNConfig

    if _want("AllDeepSets"):
        ds = SetGNNConfig.all_deep_sets(
            num_features=256, num_classes=8, all_num_layers=1, mlp_hidden=256,
            classifier_hidden=256, classifier_num_layers=1, dropout=0.0,
            dtype=dt,
        )
        t = fwd_bwd_time(SetGNN(ds), batch)
        print(f"AllDeepSets fwd+bwd: {t*1e3:7.2f} ms  ({nnz/t/1e6:6.2f} M edges/s)")

    # CEGCN over the clique expansion (factory prep, gcn_norm + self-loops)
    from allset_tpu.graph.transforms import construct_v2v, gcn_norm
    from allset_tpu.graph.batch import Batch as _B
    from allset_tpu.graph.incidence import Incidence
    from allset_tpu.models.cegnn import CEGCN, CEConfig

    if _want("CEGCN"):
        pairs, weights = construct_v2v(hd3)
        ei, nrm = gcn_norm(pairs, weights, hd3.num_nodes, add_self_loops=True)
        v2v = Incidence.from_arrays(
            ei[0], ei[1], norm=nrm, num_nodes=hd3.num_nodes,
            num_edges=hd3.num_nodes, bucket=1024,
        )
        b4 = _B(x=jnp.asarray(hd3.x), y=jnp.asarray(hd3.y, jnp.int32), inc=v2v,
                extras={})
        cfg = CEConfig(num_features=256, num_classes=8, all_num_layers=2,
                       mlp_hidden=256, dtype=dt)
        t = fwd_bwd_time(CEGCN(cfg), b4)
        print(f"CEGCN     fwd+bwd: {t*1e3:7.2f} ms  ({v2v.nnz/t/1e6:6.2f} M pairs/s)")

    # HyperGCN fast path (factory prep: mediator Laplacian)
    from allset_tpu.graph.transforms import hypergcn_edge_dict
    from allset_tpu.models.hypergcn import (
        HyperGCN, HyperGCNConfig, build_hypergcn_laplacian,
    )

    if _want("HyperGCN"):
        he = hypergcn_edge_dict(hd3)
        struct = build_hypergcn_laplacian(
            hd3.num_nodes, he, hd3.x, mediators=True, seed=0, bucket=1024
        )
        b5 = _B(x=jnp.asarray(hd3.x), y=jnp.asarray(hd3.y, jnp.int32),
                inc=struct, extras={})
        cfg = HyperGCNConfig(num_features=256, num_classes=8, all_num_layers=2,
                             dtype=dt)
        t = fwd_bwd_time(HyperGCN(cfg), b5)
        print(f"HyperGCN  fwd+bwd: {t*1e3:7.2f} ms  ({struct.nnz/t/1e6:6.2f} M entries/s)")


if __name__ == "__main__":
    main()
