"""HAN-vertical throughput on one GPU.

The reference reports HAN train time per run (``DGL_HAN/main.py:174-177``
full batch, ``train_sampling.py:345-348`` sampled). Three legs,
slope-timed like benchmarks/zoo_bench.py:

  HAN        full-batch fwd+bwd over the VEV+EVE metapath graphs
             (M metapath-pairs/s)
  SampledHAN one jitted mini-batch step at the reference batch size (32)
             and a large batch (4096) — steps/s and seeds/s — plus
             the host sampler's walk rate (the DataLoader-worker role)
  HeteroHAN  the cached-metapath hetero surface (MetapathHAN over a
             HeteroGraph, SpGEMM-composed reachability)

HAN_ONLY=HAN,SampledHAN selects legs.
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

from zoo_bench import scan_time  # noqa: E402

from allset_tpu.utils.profiling import measurement_device  # noqa: E402


def _want(name):
    only = os.environ.get("HAN_ONLY")
    if only is None:
        return True
    return name in [s.strip() for s in only.split(",")]


def main():
    print(measurement_device())
    from allset_tpu.data.synthetic import synthetic_hypergraph
    from allset_tpu.graph.batch import Batch
    from allset_tpu.graph.metapath import build_metapath_graphs
    from allset_tpu.models.han import HAN, HANConfig, han_extras

    # Degree-BOUNDED graph (planted partition, near-uniform membership):
    # metapath graphs are quadratic in per-node degree (EVE pairs =
    # sum_v deg_v^2), so the zoo's Zipf scale_free generator explodes —
    # measured 1.07e9 EVE pairs at 2^16 nodes (17 min of SpGEMM). The
    # reference's HAN datasets (walmart-export) are likewise
    # moderate-degree; this matches that regime at a defensible scale.
    N = int(os.environ.get("HAN_NODES", 1 << 16))
    M = int(os.environ.get("HAN_EDGES", 1 << 15))
    F = int(os.environ.get("HAN_FEATS", 64))
    hd = synthetic_hypergraph(
        num_nodes=N, num_hyperedges=M, avg_edge_size=12,
        num_classes=8, feature_dim=F, seed=0,
    )

    t0 = time.perf_counter()
    feats, labels, vev, eve = build_metapath_graphs(hd, bucket=1024)
    t_build = time.perf_counter() - t0
    pairs = vev.nnz + eve.nnz
    print(f"metapath build (host scipy SpGEMM): {t_build:.2f}s  "
          f"VEV nnz={vev.nnz} EVE nnz={eve.nnz}")

    cfg = HANConfig(num_features=F, num_classes=8,
                    hidden_units=8, num_heads=(8,), dropout=0.0)

    if _want("HAN"):
        batch = Batch(
            x=jnp.asarray(feats), y=jnp.asarray(labels, jnp.int32),
            inc=vev, extras=han_extras(vev, eve),
        )
        model = HAN(cfg)
        v = model.init({"params": jax.random.PRNGKey(0)}, batch, False)

        def body(p):
            g = jax.grad(
                lambda p: jnp.sum(model.apply(p, batch, False) ** 2)
            )(p)
            return jax.tree_util.tree_map(lambda a, b: a - 0.0 * b, p, g)

        t = scan_time(body, v)
        print(f"HAN       fwd+bwd: {t*1e3:7.2f} ms  "
              f"({pairs/t/1e6:6.2f} M metapath-pairs/s)")

    if _want("SampledHAN"):
        from allset_tpu.data.sampler import HANNeighborSampler
        from allset_tpu.models.han import SampledHAN

        sampler = HANNeighborSampler(hd, num_neighbors=20, seed=0)
        x_full = jnp.asarray(feats)
        model = SampledHAN(cfg)
        for B in (32, 4096):
            seeds = np.arange(B) % N
            t0 = time.perf_counter()
            reps = max(1, 2048 // B)
            for _ in range(reps):
                blocks_h = sampler.sample(seeds)
            t_sample = (time.perf_counter() - t0) / reps
            blocks = {}
            for name, b in blocks_h.items():
                blocks[f"{name}_src"] = jnp.asarray(b.src)
                blocks[f"{name}_mask"] = jnp.asarray(b.mask)
            sj = jnp.asarray(seeds)
            v = model.init({"params": jax.random.PRNGKey(0)},
                           x_full, sj, blocks, False)

            def body(p):
                g = jax.grad(
                    lambda p: jnp.sum(
                        model.apply(p, x_full, sj, blocks, False) ** 2
                    )
                )(p)
                return jax.tree_util.tree_map(lambda a, b: a - 0.0 * b, p, g)

            # sub-ms steps need a wide scan span for the slope to rise
            # above the host clock's noise
            t = scan_time(body, v, K=(256, 4096) if B <= 256 else (64, 1024))
            print(f"SampledHAN[B={B:4d}] step: {t*1e3:7.3f} ms  "
                  f"({B/t/1e3:8.1f} K seeds/s device; host sampler "
                  f"{B/t_sample/1e3:8.1f} K seeds/s)")

    if _want("HeteroHAN"):
        from allset_tpu.graph.hetero import (
            HeteroGraph, HeteroHAN, HeteroHANConfig,
        )

        g = HeteroGraph(
            num_nodes={"V": N, "E": M},
            edges={
                ("V", "Vs_E", "E"): (np.asarray(hd.node), np.asarray(hd.edge)),
                ("E", "E_Vs", "V"): (np.asarray(hd.edge), np.asarray(hd.node)),
            },
        )
        hcfg = HeteroHANConfig(num_features=F, num_classes=8,
                               hidden_units=8, num_heads=(8,), dropout=0.0)
        han = HeteroHAN(hcfg, meta_paths=[["Vs_E", "E_Vs"]], bucket=1024)
        x = jnp.asarray(hd.x)
        t0 = time.perf_counter()
        graphs = han.coalesced(g)  # SpGEMM + cache (host, once per graph)
        t_co = time.perf_counter() - t0
        hp = sum(gr.nnz for gr in graphs)
        print(f"HeteroHAN coalesce (cached after): {t_co:.2f}s  nnz={hp}")
        v = han.init({"params": jax.random.PRNGKey(0)}, g, x, False)

        def body(p):
            gr = jax.grad(
                lambda p: jnp.sum(han.apply(p, g, x, False) ** 2)
            )(p)
            return jax.tree_util.tree_map(lambda a, b: a - 0.0 * b, p, gr)

        t = scan_time(body, v)
        print(f"HeteroHAN fwd+bwd: {t*1e3:7.2f} ms  "
              f"({hp/t/1e6:6.2f} M metapath-pairs/s)")


if __name__ == "__main__":
    main()
