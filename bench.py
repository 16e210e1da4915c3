"""Benchmark: incidence edges/s per device, fwd+bwd, AllSetTransformer.

Throughput of the two-stage multiset aggregation (gather ->
segment-softmax -> segment-reduce over the incidence COO, plus the dense
GEMMs), measured as incidence edges processed per second per device for a
full training step (forward + backward + Adam update).

Prints ONE JSON line: {"metric", "value", "unit", "device"}, with the
device as JAX reports it. Runs only on a GPU: it exits non-zero, and
prints no result, when JAX finds none.

    python bench.py            # env knobs: BENCH_NODES, BENCH_EDGES,
                               # BENCH_DTYPE, BENCH_GPR, BENCH_LEARNMASK ...
"""

from __future__ import annotations

import json
import os
import time

import jax
import jax.numpy as jnp
import optax


def build(num_nodes, num_hyperedges, avg_edge_size, hidden, heads, seed=0):
    from allset_tpu.data.synthetic import scale_free_hypergraph
    from allset_tpu.graph import add_self_loops, norm_construction
    from allset_tpu.graph.batch import Batch
    from allset_tpu.models import SetGNN, SetGNNConfig

    hd = scale_free_hypergraph(
        num_nodes=num_nodes,
        num_hyperedges=num_hyperedges,
        avg_edge_size=avg_edge_size,
        feature_dim=hidden,
        seed=seed,
    )
    hd = norm_construction(add_self_loops(hd), "all_one")
    batch = Batch.from_hyperdata(
        hd, bucket=1024,
        bucket_rows=int(os.environ.get("BENCH_BUCKET_ROWS", 0)),
    )
    cfg = SetGNNConfig(
        num_features=hd.num_features,
        num_classes=8,
        all_num_layers=1,
        mlp_hidden=hidden,
        classifier_hidden=hidden,
        classifier_num_layers=1,
        heads=heads,
        dropout=0.0,
        dtype=os.environ.get("BENCH_DTYPE", "bfloat16"),
        # flagship mode variants: GPR stacks per-layer outputs; LearnMask
        # adds the SDDMM norm backward
        gpr=os.environ.get("BENCH_GPR", "0") == "1",
        learn_mask=os.environ.get("BENCH_LEARNMASK", "0") == "1",
    )
    model = SetGNN(cfg)
    return model, batch


def main() -> int:
    from allset_tpu.utils.profiling import measurement_device

    device = measurement_device()
    num_nodes = int(os.environ.get("BENCH_NODES", 1 << 17))
    num_hyperedges = int(os.environ.get("BENCH_EDGES", 1 << 16))
    avg_edge_size = int(os.environ.get("BENCH_EDGE_SIZE", 12))
    hidden = int(os.environ.get("BENCH_HIDDEN", 256))
    heads = int(os.environ.get("BENCH_HEADS", 8))
    steps_per_call = int(os.environ.get("BENCH_SCAN", 16))
    timed_calls = int(os.environ.get("BENCH_CALLS", 4))

    model, batch = build(num_nodes, num_hyperedges, avg_edge_size, hidden, heads)
    nnz = batch.inc.nnz

    from allset_tpu.train.trainer import masked_nll, torch_adam

    variables = model.init({"params": jax.random.PRNGKey(0)}, batch, False)
    params = variables["params"]
    tx = torch_adam(1e-3, 0.0)
    opt_state = tx.init(params)
    def one_step(batch, carry, _):
        params, opt_state = carry

        def loss_fn(p):
            logits = model.apply({"params": p}, batch, False)
            # mask built in-graph from an iota: no closure constant
            train_mask = jnp.arange(batch.num_nodes) % 2 == 0
            return masked_nll(logits, batch.y, train_mask)

        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return (params, opt_state), loss

    # batch is an ARGUMENT, not a closure: closed-over device arrays get
    # baked into the HLO as constants
    @jax.jit
    def run_chunk(params, opt_state, batch):
        (params, opt_state), losses = jax.lax.scan(
            lambda c, x: one_step(batch, c, x),
            (params, opt_state), None, length=steps_per_call
        )
        return params, opt_state, losses[-1]

    # compile + warmup
    params, opt_state, loss = jax.block_until_ready(
        run_chunk(params, opt_state, batch)
    )

    times = []
    for _ in range(timed_calls):
        t0 = time.perf_counter()
        params, opt_state, loss = jax.block_until_ready(
            run_chunk(params, opt_state, batch)
        )
        times.append(time.perf_counter() - t0)

    step_time = min(times) / steps_per_call
    print(
        json.dumps(
            {
                "metric": "incidence_edges_per_s_per_device_fwd_bwd",
                "value": nnz / step_time,
                "unit": "edges/s",
                "step_time_s": step_time,
                "nnz": nnz,
                "loss": float(loss),
                "device": device,
            }
        )
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
