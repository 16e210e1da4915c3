"""Distributed layer tests on the 8-device CPU mesh (SURVEY.md §4 item 4):
edge-partitioned execution must be numerically identical to single-device."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from allset_tpu.data.synthetic import synthetic_hypergraph
from allset_tpu.graph import add_self_loops, norm_construction
from allset_tpu.graph.batch import Batch
from allset_tpu.models import SetGNN, SetGNNConfig
from allset_tpu.parallel.mesh import make_mesh, replicate, shard_batch

pytestmark = pytest.mark.slow  # e2e / multi-device: see pytest.ini


def make_batch(bucket):
    hd = synthetic_hypergraph(num_nodes=96, num_hyperedges=48, seed=3)
    hd = norm_construction(add_self_loops(hd), "all_one")
    return Batch.from_hyperdata(hd, bucket=bucket), hd


@pytest.mark.parametrize("n_dev", [2, 8])
def test_sharded_forward_matches_single_device(n_dev):
    batch, hd = make_batch(bucket=64 * n_dev)
    cfg = SetGNNConfig(
        num_features=hd.num_features, num_classes=4, heads=2,
        mlp_hidden=32, classifier_num_layers=1,
    )
    model = SetGNN(cfg)
    variables = model.init(jax.random.PRNGKey(0), batch, False)
    want = np.asarray(model.apply(variables, batch, False))

    mesh = make_mesh(n_dev)
    sbatch = shard_batch(batch, mesh)
    sparams = replicate(variables, mesh)
    with mesh:
        got = np.asarray(jax.jit(lambda v, b: model.apply(v, b, False))(sparams, sbatch))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_sharded_gradients_match():
    n_dev = 8
    batch, hd = make_batch(bucket=64 * n_dev)
    cfg = SetGNNConfig.all_deep_sets(
        num_features=hd.num_features, num_classes=4,
        mlp_hidden=32, classifier_num_layers=1,
    )
    model = SetGNN(cfg)
    variables = model.init(jax.random.PRNGKey(0), batch, False)
    y = batch.y

    def loss(v, b):
        out = model.apply(v, b, False)
        logp = jax.nn.log_softmax(out)
        return -jnp.take_along_axis(logp, y[:, None], 1).mean()

    g_want = jax.grad(loss)(variables, batch)

    mesh = make_mesh(n_dev)
    sbatch = shard_batch(batch, mesh)
    sparams = replicate(variables, mesh)
    with mesh:
        g_got = jax.jit(jax.grad(loss))(sparams, sbatch)
    for a, b in zip(jax.tree_util.tree_leaves(g_want), jax.tree_util.tree_leaves(g_got)):
        np.testing.assert_allclose(np.asarray(b), np.asarray(a), rtol=1e-4, atol=1e-5)


def test_incidence_shards_land_on_distinct_devices():
    n_dev = 4
    batch, _ = make_batch(bucket=64 * n_dev)
    mesh = make_mesh(n_dev)
    sbatch = shard_batch(batch, mesh)
    shard_devs = {s.device.id for s in sbatch.inc.node.addressable_shards}
    assert len(shard_devs) == n_dev
    # features replicated everywhere
    assert len({s.device.id for s in sbatch.x.addressable_shards}) == n_dev
    for s in sbatch.x.addressable_shards:
        assert s.data.shape == batch.x.shape


def test_hybrid_mesh_single_process():
    from allset_tpu.parallel.distributed import hybrid_mesh, initialize_multihost, mesh_summary

    initialize_multihost(num_processes=1)  # no-op path
    mesh = hybrid_mesh()
    assert mesh.devices.shape == (1, 8)
    assert "edge" in mesh.axis_names
    assert "processes=1" in mesh_summary(mesh)

    batch, hd = make_batch(bucket=64 * 8)
    sbatch = shard_batch(batch, mesh)
    cfg = SetGNNConfig(
        num_features=hd.num_features, num_classes=4, heads=2,
        mlp_hidden=32, classifier_num_layers=1,
    )
    model = SetGNN(cfg)
    variables = model.init(jax.random.PRNGKey(0), batch, False)
    want = np.asarray(model.apply(variables, batch, False))
    with mesh:
        got = np.asarray(
            jax.jit(lambda v, b: model.apply(v, b, False))(replicate(variables, mesh), sbatch)
        )
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


# --- explicit shard_map edge-partitioned exchange --------------------------


def _sl_incidence(rng, n=60, m=24, nnz=300):
    from allset_tpu.graph.transforms import HyperData, add_self_loops, coalesce, norm_construction

    node = rng.integers(0, n, size=nnz)
    edge = rng.integers(0, m, size=nnz)
    node, edge = coalesce(node, edge)
    hd = HyperData(
        x=np.zeros((n, 4), np.float32), y=np.zeros(n, np.int64),
        node=node, edge=edge, num_nodes=n, num_hyperedges=m,
    )
    hd = norm_construction(add_self_loops(hd), "deg_half_sym")
    return hd.to_incidence(bucket=128)


@pytest.mark.parametrize("use_norm", [True, False])
def test_sharded_spmm_matches_single_device(rng, use_norm):
    """shard_map edge-partitioned spmm == dir_spmm (values + grads) on a
    virtual 8-device CPU mesh, both directions, with the self-loop split."""
    import jax
    import jax.numpy as jnp

    from allset_tpu.ops.exchange import dir_spmm
    from allset_tpu.parallel.mesh import make_mesh
    from allset_tpu.parallel.sharded import ShardedExchange, sharded_spmm

    inc = _sl_incidence(rng)
    mesh = make_mesh(8)
    shex = ShardedExchange.build(inc, mesh).shard()

    f = 8
    for sd, ref_d in [(shex.v2e, inc.v2e_split()), (shex.e2v, inc.e2v_split())]:
        rows = ref_d.num_src + (0 if sd.sl_mode != "add" else inc.num_nodes)
        w = jnp.asarray(rng.normal(size=(rows, f)).astype(np.float32))
        tgt_rows = sd.num_dst_total if sd.sl_mode != "none" else sd.num_dst
        t = jnp.asarray(rng.normal(size=(tgt_rows, f)).astype(np.float32))

        def loss_sh(w):
            out = sharded_spmm(w, sd, use_norm=use_norm)
            return jnp.sum((out - t) ** 2), out

        def loss_ref(w):
            out = dir_spmm(w, ref_d, norm=ref_d.norm if use_norm else None)
            return jnp.sum((out - t) ** 2), out

        (_, outs), gs = jax.value_and_grad(loss_sh, has_aux=True)(w)
        (_, outf), gf = jax.value_and_grad(loss_ref, has_aux=True)(w)
        np.testing.assert_allclose(
            np.asarray(outs), np.asarray(outf), rtol=1e-4, atol=1e-5
        )
        np.testing.assert_allclose(
            np.asarray(gs), np.asarray(gf), rtol=1e-4, atol=1e-5
        )


def test_sharded_spmm_no_split(rng):
    """Sharded exchange over a plain incidence (no self loops)."""
    import jax
    import jax.numpy as jnp

    from allset_tpu.graph.incidence import Incidence
    from allset_tpu.ops.exchange import dir_spmm
    from allset_tpu.parallel.mesh import make_mesh
    from allset_tpu.parallel.sharded import ShardedExchange, sharded_spmm

    n, m, nnz = 40, 16, 150
    node = rng.integers(0, n, size=nnz)
    edge = np.sort(rng.integers(0, m, size=nnz))
    inc = Incidence.from_arrays(node, edge, num_nodes=n, num_edges=m, bucket=128)
    mesh = make_mesh(8)
    shex = ShardedExchange.build(inc, mesh).shard()

    w = jnp.asarray(rng.normal(size=(n, 8)).astype(np.float32))
    out = np.asarray(sharded_spmm(w, shex.v2e, use_norm=True))
    want = np.asarray(dir_spmm(w, inc.v2e(), norm=inc.norm))
    np.testing.assert_allclose(out, want, rtol=1e-4, atol=1e-5)


def test_setgnn_sharded_exchange_matches_plain(rng):
    """Full SetGNN forward+grads through the shard_map exchange == the
    plain (Direction.plain, XLA) path on the same 8-device CPU mesh."""
    import dataclasses

    import jax
    import jax.numpy as jnp

    from allset_tpu.graph.batch import Batch
    from allset_tpu.graph.transforms import (
        HyperData, add_self_loops, coalesce, norm_construction,
    )
    from allset_tpu.models import SetGNN, SetGNNConfig
    from allset_tpu.parallel.mesh import make_mesh
    from allset_tpu.parallel.sharded import ShardedExchange

    n, m, nnz = 48, 20, 220
    node = rng.integers(0, n, size=nnz)
    edge = rng.integers(0, m, size=nnz)
    node, edge = coalesce(node, edge)
    hd = HyperData(
        x=rng.normal(size=(n, 16)).astype(np.float32),
        y=rng.integers(0, 4, size=n), node=node, edge=edge,
        num_nodes=n, num_hyperedges=m,
    )
    hd = norm_construction(add_self_loops(hd), "all_one")
    batch = Batch.from_hyperdata(hd, bucket=128)
    mesh = make_mesh(8)
    shex = ShardedExchange.build(batch.inc, mesh).shard()
    batch_sh = dataclasses.replace(batch, shex=shex)

    cfg = SetGNNConfig(
        num_features=16, num_classes=4, all_num_layers=1,
        mlp_hidden=32, classifier_hidden=32, classifier_num_layers=1,
        heads=4, dropout=0.0,
    )
    model = SetGNN(cfg)
    v = model.init({"params": jax.random.PRNGKey(0)}, batch, False)

    def loss(v, b):
        out = model.apply(v, b, False)
        return jnp.sum(out**2)

    l_sh, g_sh = jax.value_and_grad(loss)(v, batch_sh)
    l_pl, g_pl = jax.value_and_grad(loss)(v, batch)
    np.testing.assert_allclose(float(l_sh), float(l_pl), rtol=1e-4)
    for a, b in zip(
        jax.tree_util.tree_leaves(g_sh), jax.tree_util.tree_leaves(g_pl)
    ):
        np.testing.assert_allclose(
            np.asarray(a), np.asarray(b), rtol=1e-3, atol=1e-4
        )


def test_sharded_learnmask_grads_match(rng):
    """SetGNN LearnMask over the shard_map exchange (split=False): loss
    and ALL gradients — including the per-entry importance parameter via
    the sharded SDDMM + psum — match single-device."""
    import dataclasses

    import jax
    import jax.numpy as jnp

    from allset_tpu.graph.batch import Batch
    from allset_tpu.graph.transforms import (
        HyperData, add_self_loops, coalesce, norm_construction,
    )
    from allset_tpu.models import SetGNN, SetGNNConfig
    from allset_tpu.parallel.sharded import ShardedExchange

    n, m, nnz = 48, 20, 220
    node = rng.integers(0, n, size=nnz)
    edge = rng.integers(0, m, size=nnz)
    node, edge = coalesce(node, edge)
    hd = HyperData(
        x=rng.normal(size=(n, 16)).astype(np.float32),
        y=rng.integers(0, 4, size=n), node=node, edge=edge,
        num_nodes=n, num_hyperedges=m,
    )
    hd = norm_construction(add_self_loops(hd), "all_one")
    batch = Batch.from_hyperdata(hd, bucket=128)
    mesh = make_mesh(8)
    shex = ShardedExchange.build(batch.inc, mesh, split=False).shard()
    assert shex.v2e.sl_mode == "none"
    batch_sh = dataclasses.replace(batch, shex=shex)

    cfg = SetGNNConfig.all_deep_sets(
        num_features=16, num_classes=4, all_num_layers=1,
        mlp_hidden=32, classifier_hidden=32, classifier_num_layers=1,
        dropout=0.0, learn_mask=True,
    )
    model = SetGNN(cfg)
    v = model.init({"params": jax.random.PRNGKey(0)}, batch, False)
    assert "importance" in v["params"]

    def loss(v, b):
        return jnp.sum(model.apply(v, b, False) ** 2)

    l_sh, g_sh = jax.value_and_grad(loss)(v, batch_sh)
    l_pl, g_pl = jax.value_and_grad(loss)(v, batch)
    np.testing.assert_allclose(float(l_sh), float(l_pl), rtol=1e-4)
    gi_sh = np.asarray(g_sh["params"]["importance"])
    gi_pl = np.asarray(g_pl["params"]["importance"])
    assert np.abs(gi_pl).max() > 0  # the SDDMM actually fires
    np.testing.assert_allclose(gi_sh, gi_pl, rtol=1e-3, atol=1e-5)
    for a, b in zip(
        jax.tree_util.tree_leaves(g_sh), jax.tree_util.tree_leaves(g_pl)
    ):
        np.testing.assert_allclose(
            np.asarray(a), np.asarray(b), rtol=1e-3, atol=1e-4
        )


@pytest.mark.parametrize("use_norm", [True, False])
def test_sharded_max_matches_single_device(rng, use_norm):
    """Sharded 'max' reduce (per-shard segment-max, disjoint dst blocks):
    values and gradients match the single-chip path."""
    import jax
    import jax.numpy as jnp

    from allset_tpu.ops.exchange import dir_spmm
    from allset_tpu.parallel.sharded import ShardedExchange, sharded_spmm

    inc = _sl_incidence(rng)
    mesh = make_mesh(8)
    shex = ShardedExchange.build(inc, mesh).shard()

    for sd, ref_d in [(shex.v2e, inc.v2e_split()), (shex.e2v, inc.e2v_split())]:
        rows = ref_d.num_src + (0 if sd.sl_mode != "add" else inc.num_nodes)
        w = jnp.asarray(rng.normal(size=(rows, 8)).astype(np.float32))

        def f_sh(w):
            return sharded_spmm(w, sd, use_norm=use_norm, reduce="max")

        def f_ref(w):
            return dir_spmm(
                w, ref_d, norm=ref_d.norm if use_norm else None, reduce="max"
            )

        out_sh, out_ref = f_sh(w), f_ref(w)
        np.testing.assert_allclose(
            np.asarray(out_sh), np.asarray(out_ref), rtol=1e-5, atol=1e-6
        )
        g_sh = jax.grad(lambda w: (f_sh(w) ** 2).sum())(w)
        g_ref = jax.grad(lambda w: (f_ref(w) ** 2).sum())(w)
        np.testing.assert_allclose(
            np.asarray(g_sh), np.asarray(g_ref), rtol=1e-4, atol=1e-5
        )


def test_sharded_learnmask_pma_matches(rng):
    """AllSetTransformer (PMA) + LearnMask over the shard_map exchange:
    PMA's attention aggregation is UNWEIGHTED (the reference's PMA never
    reads norm, src/layers.py:128-157) — the traced importance norm must
    not leak into it on the sharded path (code-review r2 finding:
    dir_spmm applied norm_canon even for norm=None callers, a 0.21
    forward divergence)."""
    import dataclasses

    import jax
    import jax.numpy as jnp

    from allset_tpu.graph.batch import Batch
    from allset_tpu.graph.transforms import (
        HyperData, add_self_loops, coalesce, norm_construction,
    )
    from allset_tpu.models import SetGNN, SetGNNConfig
    from allset_tpu.parallel.sharded import ShardedExchange

    n, m, nnz = 48, 20, 220
    node = rng.integers(0, n, size=nnz)
    edge = rng.integers(0, m, size=nnz)
    node, edge = coalesce(node, edge)
    hd = HyperData(
        x=rng.normal(size=(n, 16)).astype(np.float32),
        y=rng.integers(0, 4, size=n), node=node, edge=edge,
        num_nodes=n, num_hyperedges=m,
    )
    hd = norm_construction(add_self_loops(hd), "all_one")
    batch = Batch.from_hyperdata(hd, bucket=128)
    mesh = make_mesh(8)
    shex = ShardedExchange.build(batch.inc, mesh, split=False).shard()
    batch_sh = dataclasses.replace(batch, shex=shex)

    cfg = SetGNNConfig(
        num_features=16, num_classes=4, all_num_layers=1,
        mlp_hidden=32, classifier_hidden=32, classifier_num_layers=1,
        heads=2, dropout=0.0, learn_mask=True,
    )
    model = SetGNN(cfg)
    v = model.init({"params": jax.random.PRNGKey(0)}, batch, False)
    # non-trivial importance so a leak into PMA would change the forward
    v = jax.tree_util.tree_map(lambda a: a, v)
    v["params"]["importance"] = 1.0 + 0.5 * jnp.asarray(
        rng.normal(size=v["params"]["importance"].shape), jnp.float32
    )

    out_pl = model.apply(v, batch, False)
    out_sh = model.apply(v, batch_sh, False)
    np.testing.assert_allclose(
        np.asarray(out_sh), np.asarray(out_pl), rtol=1e-4, atol=1e-5
    )


# --- compiled-program communication census ---------------------------------


def _collective_census(txt):
    """Count collective payloads by (opcode, result shape) in compiled HLO
    text. Tuple-shaped collectives (XLA's all-reduce combiner merges
    independent psums, e.g. dw + dnorm from one shard_map body) count one
    entry per component, so the census stays a faithful payload census."""
    import re
    from collections import Counter

    c = Counter()
    pat = re.compile(
        r"= (.*?) (all-[a-z-]+|collective-[a-z-]+|reduce-scatter)\("
    )
    for m in pat.finditer(txt):
        op = m.group(2)
        if op.endswith(("-start", "-done")):
            continue
        for t, s in re.findall(r"([a-z0-9]+)\[([0-9,]*)\]", m.group(1)):
            c[(op, f"{t}[{s}]")] += 1
    return c


def test_sharded_step_collective_census(rng):
    """Prove parallel/sharded.py's communication claims on the COMPILED
    program: per exchange, the forward carries exactly
    one explicit output-reassembly ALL-GATHER (r5; [D*rows_per_shard, W]
    stacked disjoint blocks — half an all-reduce's wire bytes) and the
    backward exactly one dw psum ([num_src, W]); no all-to-all /
    collective-permute / reduce-scatter anywhere (SURVEY.md §4 item 4;
    chip_smoke.py --chips 4 counts the same collectives on four cards)."""
    import dataclasses

    from allset_tpu.graph.transforms import HyperData
    from allset_tpu.parallel.sharded import ShardedExchange, sharded_comm_stats

    n, m, nnz = 48, 20, 220
    node = rng.integers(0, n, size=nnz)
    edge = rng.integers(0, m, size=nnz)
    from allset_tpu.graph.transforms import coalesce

    node, edge = coalesce(node, edge)
    hd = HyperData(
        x=rng.normal(size=(n, 16)).astype(np.float32),
        y=rng.integers(0, 4, size=n), node=node, edge=edge,
        num_nodes=n, num_hyperedges=m,
    )
    hd = norm_construction(add_self_loops(hd), "all_one")
    batch = Batch.from_hyperdata(hd, bucket=128)
    mesh = make_mesh(8)
    shex = ShardedExchange.build(batch.inc, mesh).shard()
    bsh = dataclasses.replace(batch, shex=shex)

    L, H, HID = 2, 4, 32
    cfg = SetGNNConfig(
        num_features=16, num_classes=4, all_num_layers=L,
        mlp_hidden=HID, classifier_hidden=32, classifier_num_layers=1,
        heads=H, dropout=0.0,
    )
    model = SetGNN(cfg)
    v = model.init({"params": jax.random.PRNGKey(0)}, batch, False)
    W = HID + H  # packed exchange width [values | seed scores]
    # num_dst of V2E = hyperedges (padded rows per shard sum back to
    # num_dst_padded); num_dst of E2V = nodes; dw is [num_src, W]
    assert shex.v2e.num_src == n and shex.e2v.num_src == m
    m_dst = shex.v2e.num_dst  # hyperedges
    n_dst = shex.e2v.num_dst  # nodes

    fwd_txt = (
        jax.jit(lambda v, b: model.apply(v, b, False)).lower(v, bsh).compile().as_text()
    )
    census_f = _collective_census(fwd_txt)
    # forward: one reassembly all-gather per exchange, nothing else
    from collections import Counter

    g_v = 8 * shex.v2e.rows_per_shard
    g_e = 8 * shex.e2v.rows_per_shard
    want_f = Counter()
    want_f[("all-gather", f"f32[{g_v},{W}]")] += L
    want_f[("all-gather", f"f32[{g_e},{W}]")] += L
    assert census_f == want_f, census_f

    def loss(v, b):
        out = model.apply(v, b, False)
        return jnp.sum(out**2)

    step_txt = jax.jit(jax.grad(loss)).lower(v, bsh).compile().as_text()
    census_s = _collective_census(step_txt)
    # step = forward census + exactly one dw psum per exchange backward:
    # V2E's dw is [num_nodes, W], E2V's dw is [num_edges, W]
    want = Counter(want_f)
    for shape, cnt in [
        (f"f32[{n},{W}]", L), (f"f32[{m},{W}]", L),  # dw psums
    ]:
        want[("all-reduce", shape)] += cnt
    assert census_s == want, census_s

    # the accounting helper agrees with the census (per V2E+E2V pass)
    stats = sharded_comm_stats(shex, W)
    assert stats["reassembly_fwd"] == 2 and stats["psums_bwd"] == 2
    assert stats["fwd_bytes"] == (g_v + g_e) * W * 4
    assert stats["bwd_bytes"] == (n + m) * W * 4


def test_sharded_vmapped_runs_match_sequential(rng):
    """The canonical vmapped statistical-runs protocol over the
    shard_map edge-partitioned exchange: vmap pushes the
    runs axis inside the shard bodies where the runs-folding batching
    rules apply; a vmapped multi-run sharded fit must equal the same
    runs trained sequentially (same rng streams, same step function)."""
    import dataclasses

    from allset_tpu.graph.transforms import HyperData, coalesce
    from allset_tpu.parallel.sharded import ShardedExchange
    from allset_tpu.train import TrainConfig, Trainer

    n, m, nnz = 48, 20, 220
    node = rng.integers(0, n, size=nnz)
    edge = rng.integers(0, m, size=nnz)
    node, edge = coalesce(node, edge)
    hd = HyperData(
        x=rng.normal(size=(n, 16)).astype(np.float32),
        y=rng.integers(0, 4, size=n), node=node, edge=edge,
        num_nodes=n, num_hyperedges=m,
    )
    hd = norm_construction(add_self_loops(hd), "all_one")
    batch = Batch.from_hyperdata(hd, bucket=128)
    mesh = make_mesh(8)
    shex = ShardedExchange.build(batch.inc, mesh).shard()
    bsh = dataclasses.replace(batch, shex=shex)

    cfg = SetGNNConfig(
        num_features=16, num_classes=4, all_num_layers=1,
        mlp_hidden=32, classifier_hidden=32, classifier_num_layers=1,
        heads=4, dropout=0.0,
    )
    model = SetGNN(cfg)

    kw = dict(epochs=5, runs=3, lr=1e-2, seed=0)
    res_v = Trainer(model, bsh, TrainConfig(vmap_runs=True, **kw)).fit()
    res_s = Trainer(model, bsh, TrainConfig(vmap_runs=False, **kw)).fit()
    np.testing.assert_allclose(
        res_v.metrics, res_s.metrics, rtol=1e-4, atol=1e-5
    )
    # and the sharded vmapped protocol agrees with the plain single-mesh
    # batch (the exchange itself is numerics-identical)
    res_p = Trainer(model, batch, TrainConfig(vmap_runs=True, **kw)).fit()
    np.testing.assert_allclose(
        res_v.metrics, res_p.metrics, rtol=1e-3, atol=1e-4
    )


# --- zoo + LearnMask collective census ----------------------


def _zoo_setup(method, split, **cfg_kw):
    """prepare() a model via the factory, attach a ShardedExchange built
    with the given split mode, and return (model, batch, bsh, shex)."""
    import dataclasses

    from allset_tpu.parallel.sharded import ShardedExchange
    from allset_tpu.train.factory import ExperimentConfig, prepare

    hd = synthetic_hypergraph(num_nodes=48, num_hyperedges=20, seed=3)
    cfg = ExperimentConfig(method=method, mlp_hidden=32, dropout=0.0,
                           bucket=128, **cfg_kw)
    model, batch, _ = prepare(cfg, hd)
    mesh = make_mesh(8)
    shex = ShardedExchange.build(batch.inc, mesh, split=split).shard()
    # replicated batch (no shard_batch): the shex path never reads the
    # incidence entry arrays except the LearnMask norm, which must stay
    # replicated — nnz-sharding it would force an all-gather at the
    # shard_map boundary and pollute the census
    bsh = dataclasses.replace(batch, shex=shex)
    return model, batch, bsh, shex


def _census_pair(model, v, bsh):
    """(forward census, grad-step census) on the compiled HLO."""

    def loss(v, b):
        out = model.apply(v, b, False)
        return jnp.sum(out.astype(jnp.float32) ** 2)

    fwd_txt = (
        jax.jit(lambda v, b: model.apply(v, b, False))
        .lower(v, bsh).compile().as_text()
    )
    step_txt = jax.jit(jax.grad(loss)).lower(v, bsh).compile().as_text()
    return _collective_census(fwd_txt), _collective_census(step_txt)


def test_sharded_census_hcha():
    """HCHA over the shard_map exchange (new r4 routing: models/hcha.py
    picks batch.shex): per conv, fwd = one reassembly all-reduce per
    direction, bwd adds one dw psum per direction; the dense self-loop
    slots (sl_mode append/add) and the B^-1 / D^-1 row scalings are
    replicated math and must add NO collectives."""
    from collections import Counter

    model, batch, bsh, shex = _zoo_setup("HCHA", split=None)
    v = model.init({"params": jax.random.PRNGKey(0)}, batch, False)

    # numerical parity of the new routing first
    want = np.asarray(model.apply(v, batch, False))
    with shex.v2e.mesh:
        got = np.asarray(model.apply(v, bsh, False))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)

    census_f, census_s = _census_pair(model, v, bsh)
    widths = [32, batch.y.max().item() + 1]  # conv0 hidden, conv1 classes
    g_v = 8 * shex.v2e.rows_per_shard
    g_e = 8 * shex.e2v.rows_per_shard
    n_src, m_src = shex.v2e.num_src, shex.e2v.num_src
    want_f, want_s = Counter(), Counter()
    for w in widths:
        want_f[("all-gather", f"f32[{g_v},{w}]")] += 1
        want_f[("all-gather", f"f32[{g_e},{w}]")] += 1
        want_s[("all-gather", f"f32[{g_v},{w}]")] += 1
        want_s[("all-gather", f"f32[{g_e},{w}]")] += 1
        want_s[("all-reduce", f"f32[{n_src},{w}]")] += 1
        want_s[("all-reduce", f"f32[{m_src},{w}]")] += 1
    assert census_f == want_f, (census_f, want_f)
    assert census_s == want_s, (census_s, want_s)


def test_sharded_census_unigcnii():
    """UniGCNII over the shard_map exchange (unsplit build — UniGNN
    semantics treat every entry uniformly). 2 convs, each one V2E + E2V
    pass at width nhid; the degV/degE scalings and the GCNII identity
    mixing are replicated; lin_in/lin_out are replicated GEMMs."""
    from collections import Counter

    model, batch, bsh, shex = _zoo_setup("UniGCNII", split=False)
    v = model.init({"params": jax.random.PRNGKey(0)}, batch, False)

    want = np.asarray(model.apply(v, batch, False))
    with shex.v2e.mesh:
        got = np.asarray(model.apply(v, bsh, False))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)

    census_f, census_s = _census_pair(model, v, bsh)
    L, nhid = 2, 32
    g_v = 8 * shex.v2e.rows_per_shard
    g_e = 8 * shex.e2v.rows_per_shard
    n_src, m_src = shex.v2e.num_src, shex.e2v.num_src
    want_f = Counter()
    want_f[("all-gather", f"f32[{g_v},{nhid}]")] += L
    want_f[("all-gather", f"f32[{g_e},{nhid}]")] += L  # may collide: +=
    want_s = Counter(want_f)
    want_s[("all-reduce", f"f32[{n_src},{nhid}]")] += L
    want_s[("all-reduce", f"f32[{m_src},{nhid}]")] += L
    assert census_f == want_f, (census_f, want_f)
    assert census_s == want_s, (census_s, want_s)


def test_sharded_census_learnmask():
    """AllDeepSets + LearnMask over the UNSPLIT shard_map exchange: the
    traced per-entry norm adds exactly one dnorm psum per direction per
    layer in the backward (the SDDMM pass, parallel/sharded.py), in
    canonical entry order f32[nnz_pad]; the forward census is unchanged.
    sharded_comm_stats(learn_mask=True) must agree."""
    from collections import Counter

    from allset_tpu.parallel.sharded import sharded_comm_stats

    model, batch, bsh, shex = _zoo_setup(
        "AllDeepSets", split=False, learn_mask=True, mlp_num_layers=1,
        classifier_num_layers=1, all_num_layers=2,
    )
    v = model.init({"params": jax.random.PRNGKey(0)}, batch, False)

    want = np.asarray(model.apply(v, batch, False))
    with shex.v2e.mesh:
        got = np.asarray(model.apply(v, bsh, False))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)

    census_f, census_s = _census_pair(model, v, bsh)
    L, W = 2, 32
    g_v = 8 * shex.v2e.rows_per_shard
    g_e = 8 * shex.e2v.rows_per_shard
    n_src, m_src = shex.v2e.num_src, shex.e2v.num_src
    nnz_pad = shex.v2e.nnz_pad_canon
    want_f = Counter()
    want_f[("all-gather", f"f32[{g_v},{W}]")] += L
    want_f[("all-gather", f"f32[{g_e},{W}]")] += L  # may collide: +=
    want_s = Counter(want_f)
    want_s[("all-reduce", f"f32[{n_src},{W}]")] += L
    want_s[("all-reduce", f"f32[{m_src},{W}]")] += L
    want_s[("all-reduce", f"f32[{nnz_pad}]")] += 2 * L  # dnorm SDDMM psums
    assert census_f == want_f, (census_f, want_f)
    assert census_s == want_s, (census_s, want_s)

    stats = sharded_comm_stats(shex, W, learn_mask=True)
    assert stats["psums_bwd"] == 4  # (dw + dnorm) per direction
    assert stats["bwd_bytes"] == (n_src + m_src) * W * 4 + 2 * nnz_pad * 4

    # the LearnMask gradient actually reaches the importance param
    def loss(v, b):
        return jnp.sum(model.apply(v, b, False) ** 2)

    with shex.v2e.mesh:
        g = jax.grad(loss)(v, bsh)
    gi = np.asarray(g["params"]["importance"])
    assert np.abs(gi).max() > 0
    g1 = jax.grad(loss)(v, batch)
    np.testing.assert_allclose(
        gi, np.asarray(g1["params"]["importance"]), rtol=1e-3, atol=1e-5
    )
