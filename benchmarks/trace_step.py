"""Trace the bench training step on one GPU and print per-op device time.

    python benchmarks/trace_step.py     # TRACE_MODEL=HCHA|HNHN|UniGCNII
                                        # TRACE_DIR=<dir> (default .traces/)

The trace of one scanned call of 8 steps lands in TRACE_DIR; the summary
lists, for each device plane, the device time of every profiler line and
the ops that take the most of it.
"""

import os
import shutil
import sys

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)

import glob
import jax
import jax.numpy as jnp

from allset_tpu.utils.profiling import measurement_device

STEPS = 8


def _build_zoo(which: str):
    """TRACE_MODEL=HCHA|HNHN|UniGCNII traces a zoo model instead of the
    flagship (same graph as benchmarks/zoo_bench.py)."""
    from allset_tpu.data.synthetic import scale_free_hypergraph
    from allset_tpu.graph import add_self_loops, norm_construction
    from allset_tpu.graph.batch import Batch
    from allset_tpu.graph.transforms import generate_norm_hnhn, unignn_degrees

    hd = scale_free_hypergraph(
        num_nodes=1 << 17, num_hyperedges=1 << 16, avg_edge_size=12,
        feature_dim=256, seed=0,
    )
    kw = dict(num_features=256, num_classes=8, all_num_layers=2,
              mlp_hidden=256, dtype="bfloat16")
    if which == "HCHA":
        from allset_tpu.models.hcha import HCHA, HCHAConfig

        hd = norm_construction(add_self_loops(hd), "all_one")
        return HCHA(HCHAConfig(**kw)), Batch.from_hyperdata(hd, bucket=1024)
    if which == "HNHN":
        from allset_tpu.models.hnhn import HNHN, HNHNConfig

        hd = norm_construction(add_self_loops(hd), "all_one")
        hd = generate_norm_hnhn(hd, alpha=-1.5, beta=-0.5)
        return HNHN(HNHNConfig(**kw)), Batch.from_hyperdata(hd, bucket=1024)
    from allset_tpu.models.unignn import UniGCNII, UniGCNIIConfig

    hd = norm_construction(hd, "all_one")
    degV, degE = unignn_degrees(hd)
    hd.extras = dict(hd.extras, degV=degV, degE=degE)
    return UniGCNII(UniGCNIIConfig(**kw)), Batch.from_hyperdata(hd, bucket=1024)


def main():
    print(measurement_device())
    import bench
    import optax
    from allset_tpu.train.trainer import masked_nll, torch_adam

    which = os.environ.get("TRACE_MODEL", "")
    if which:
        model, batch = _build_zoo(which)
    else:
        model, batch = bench.build(
            int(os.environ.get("BENCH_NODES", 1 << 17)),
            int(os.environ.get("BENCH_EDGES", 1 << 16)),
            12, 256, 8,
        )
    variables = model.init({"params": jax.random.PRNGKey(0)}, batch, False)
    params = variables["params"]
    tx = torch_adam(1e-3, 0.0)
    opt_state = tx.init(params)
    train_mask = jnp.arange(batch.num_nodes) % 2 == 0

    def one_step(carry, _):
        params, opt_state = carry

        def loss_fn(p):
            logits = model.apply({"params": p}, batch, False)
            return masked_nll(logits, batch.y, train_mask)

        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return (params, opt_state), loss

    @jax.jit
    def run_chunk(params, opt_state):
        (params, opt_state), losses = jax.lax.scan(
            one_step, (params, opt_state), None, length=STEPS
        )
        return params, opt_state, losses[-1]

    jax.block_until_ready(run_chunk(params, opt_state))

    tmpdir = os.environ.get("TRACE_DIR", os.path.join(_REPO, ".traces", "trace_step"))
    shutil.rmtree(tmpdir, ignore_errors=True)
    jax.profiler.start_trace(tmpdir)
    jax.block_until_ready(run_chunk(params, opt_state))
    jax.profiler.stop_trace()

    files = glob.glob(f"{tmpdir}/**/*.xplane.pb", recursive=True)
    print("xplane files:", files)
    if not files:
        return
    data = jax.profiler.ProfileData.from_file(files[0])
    for plane in data.planes:
        if not plane.name.startswith("/device:"):
            continue
        print(f"== {plane.name}")
        busiest, busiest_ns = None, 0
        for line in plane.lines:
            ns = sum(ev.duration_ns for ev in line.events)
            print(f"   line {line.name!r}: {ns / 1e6 / STEPS:8.3f} ms/step")
            if ns > busiest_ns:
                busiest, busiest_ns = line, ns
        if busiest is None:
            continue
        agg = {}
        for ev in busiest.events:
            agg[ev.name] = agg.get(ev.name, 0) + ev.duration_ns
        items = sorted(agg.items(), key=lambda kv: -kv[1])
        print(f"-- top ops of {busiest.name!r} (ms/step):")
        for name, dur in items[:40]:
            print(f"   {dur / 1e6 / STEPS:8.3f}  {name[:120]}")
        tail = sum(d for _, d in items[40:])
        print(f"   {tail / 1e6 / STEPS:8.3f}  == tail ({max(len(items) - 40, 0)} distinct ops)")


if __name__ == "__main__":
    main()
