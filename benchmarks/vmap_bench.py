"""Measure the vmapped statistical-run protocol's throughput.

The reference's actual workload is 20 independent runs of the full
training loop (``src/train.py:458-499``); our Trainer vmaps them, and
the runs-folding primitives (ops/fold.py) fold the runs axis into the
width of every gather and reduce. This harness times the SAME flagship
training step vmapped over R parameter replicas and reports total
incidence edges/s (R * nnz / step) against the single-run rate, on one
GPU.

    BENCH_RUNS=8 python benchmarks/vmap_bench.py

Env knobs shared with bench.py: BENCH_NODES/EDGES/SCAN/CALLS. Default
graph is HALF the bench scale.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import optax

from allset_tpu.utils.profiling import measurement_device


def main():
    device = measurement_device()
    import bench
    from allset_tpu.train.trainer import masked_nll, torch_adam

    R = int(os.environ.get("BENCH_RUNS", 8))
    num_nodes = int(os.environ.get("BENCH_NODES", 1 << 16))
    num_hyperedges = int(os.environ.get("BENCH_EDGES", 1 << 15))
    steps_per_call = int(os.environ.get("BENCH_SCAN", 8))
    timed_calls = int(os.environ.get("BENCH_CALLS", 4))

    model, batch = bench.build(num_nodes, num_hyperedges, 12, 256, 8)
    nnz = batch.inc.nnz

    variables = model.init({"params": jax.random.PRNGKey(0)}, batch, False)
    tx = torch_adam(1e-3, 0.0)

    def one_step(batch, carry, _):
        params, opt_state = carry

        def loss_fn(p):
            logits = model.apply({"params": p}, batch, False)
            train_mask = jnp.arange(batch.num_nodes) % 2 == 0
            return masked_nll(logits, batch.y, train_mask)

        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return (params, opt_state), loss

    def time_chunk(params0, opt0, vmapped):
        # batch is a jit ARGUMENT (closure arrays would bake into the HLO)
        @jax.jit
        def run_chunk(params, opt_state, b):
            if vmapped:
                inner = lambda c, x: jax.vmap(
                    lambda p, o: one_step(b, (p, o), x)
                )(*c)
            else:
                inner = lambda c, x: one_step(b, c, x)
            (params, opt_state), losses = jax.lax.scan(
                inner, (params, opt_state), None, length=steps_per_call,
            )
            return params, opt_state, losses

        p, o, losses = jax.block_until_ready(run_chunk(params0, opt0, batch))
        times = []
        for _ in range(timed_calls):
            t0 = time.perf_counter()
            p, o, losses = jax.block_until_ready(run_chunk(p, o, batch))
            times.append(time.perf_counter() - t0)
        return min(times) / steps_per_call

    params = variables["params"]
    opt_state = tx.init(params)
    t_single = time_chunk(params, opt_state, vmapped=False)

    params_r = jax.tree_util.tree_map(
        lambda a: jnp.stack([a] * R), params
    )
    opt_r = jax.vmap(tx.init)(params_r)
    t_vmap = time_chunk(params_r, opt_r, vmapped=True)

    single_rate = nnz / t_single
    vmap_rate = nnz * R / t_vmap
    out = {
        "metric": "vmapped_protocol_edges_per_s",
        "runs": R,
        "nnz": nnz,
        "num_nodes": num_nodes,
        "num_hyperedges": num_hyperedges,
        "single_run_step_s": t_single,
        "vmapped_step_s": t_vmap,
        "single_run_edges_per_s": single_rate,
        "vmapped_total_edges_per_s": vmap_rate,
        "vmap_efficiency": vmap_rate / single_rate,
        "device": device,
    }
    print(json.dumps(out))


if __name__ == "__main__":
    main()
