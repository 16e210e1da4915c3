"""On-card smoke test: the AllSetTransformer trainer end to end on a GPU.

    python chip_smoke.py             # one card: device, ops, train
    python chip_smoke.py --chips 4   # four cards: the edge-partitioned step

Phases (each failure exits non-zero; no phase is skipped or caught):

  device      JAX must see a GPU. Prints the card as JAX and nvidia-smi
              report it, the JAX version, the compile-cache directory and
              whether the native host library loaded.
  ops         At flagship width on the walmart-trips-100-shaped graph,
              each op of the hot path, forward and gradient, against a
              plain float32 jax.numpy reference computed on the card at
              "highest" matmul precision. Then the XLA times of the sorted
              segment reduce and of the PMA epilogue.
  train       allset_tpu.cli at the walmart-trips-100 preset widths, in
              float32 and bfloat16, plus one HCHA leg: metrics finite, the
              training loss falls.
  four_cards  (--chips 4 only, alone) one training step through the GSPMD
              route and through the explicit ShardedExchange route, each
              compared with a one-card step on device 0.

Tolerances, each printed beside its error (relative to the reference's
largest magnitude):
  * float32 at highest precision: 1e-5 — only the summation order
    differs (XLA's GPU scatter-add uses atomics);
  * bfloat16: 2e-2 — bf16 keeps an 8-bit mantissa; sums accumulate in
    float32;
  * float32 at default precision: 1e-2 — a float32 matmul may run in TF32.

The last line of standard output is one JSON object:
  {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# the walmart-trips-100 preset widths (train/presets.py), passed explicitly
# because --preset forces the 500-epoch x 20-run protocol
FLAGSHIP_ARGS = [
    "--method", "AllSetTransformer", "--All_num_layers", "1",
    "--MLP_num_layers", "2", "--MLP_hidden", "256",
    "--Classifier_hidden", "128", "--heads", "8",
]
# walmart-trips-100's published shape (data/registry.py)
DNAME = "synthetic-walmart"
TOL_F32_HIGHEST = 1e-5
TOL_BF16 = 2e-2
TOL_F32_DEFAULT = 1e-2


class PhaseFailed(Exception):
    pass


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--chips", type=int, choices=(1, 4), default=1,
                   help="4 runs only the four-card phase")
    return p.parse_args(argv)


def phases(args: argparse.Namespace) -> list:
    """The phases a run executes, in order."""
    if args.chips == 4:
        return ["device", "four_cards"]
    return ["device", "ops", "train"]


# --- device -------------------------------------------------------------------


def phase_device(n_cards: int) -> dict:
    import jax

    from allset_tpu.graph import native
    from allset_tpu.utils.compile_cache import enable_compile_cache

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise PhaseFailed(f"JAX found platform {devs[0].platform!r}, not 'gpu'")
    if len(devs) < n_cards:
        raise PhaseFailed(f"need {n_cards} GPUs, JAX found {len(devs)}")
    cache = enable_compile_cache()
    info = {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}
    print(f"[device] {info}")
    print(f"[device] jax {jax.__version__}; compile cache {cache}")
    print(f"[device] native host library loaded: {native.available()}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if smi.returncode != 0:
        raise PhaseFailed(f"nvidia-smi failed: {smi.stderr.strip()}")
    for line in smi.stdout.strip().splitlines():
        print(f"[device] nvidia-smi: {line.strip()}")
    return info


# --- ops ----------------------------------------------------------------------


class Checks:
    """Collects comparisons; a phase fails after all of them printed."""

    def __init__(self, phase: str):
        self.phase = phase
        self.failed = []

    def close(self, name, got, want, tol, rows=None):
        import numpy as np

        got = np.asarray(got, dtype=np.float32)
        want = np.asarray(want, dtype=np.float32)
        if got.shape != want.shape:
            self.failed.append(name)
            print(f"[{self.phase}] {name}: shape {got.shape} != {want.shape} FAIL")
            return
        if rows is not None:
            got, want = got[rows], want[rows]
        finite = bool(np.isfinite(got).all())
        scale = max(float(np.abs(want).max()) if want.size else 0.0, 1e-30)
        err = float(np.abs(got - want).max()) / scale if want.size else 0.0
        ok = finite and err <= tol
        if not ok:
            self.failed.append(name)
        print(f"[{self.phase}] {name:58s} err {err:.2e} tol {tol:.0e} "
              f"{'ok' if ok else 'FAIL'}")

    def done(self):
        if self.failed:
            raise PhaseFailed(f"{len(self.failed)} comparisons out of "
                              f"tolerance: {self.failed}")


def build_flagship(dname: str, dtype: str):
    """(model, batch) exactly as the cli builds them for the flagship."""
    from allset_tpu.cli import build_parser
    from allset_tpu.data.registry import load_dataset
    from allset_tpu.train.factory import ExperimentConfig, prepare

    a = build_parser().parse_args(FLAGSHIP_ARGS + ["--dname", dname])
    data = load_dataset(dname, feature_noise=1.0, seed=0)
    cfg = ExperimentConfig(
        method=a.method, dname=dname, all_num_layers=a.All_num_layers,
        mlp_num_layers=a.MLP_num_layers, mlp_hidden=a.MLP_hidden,
        classifier_hidden=a.Classifier_hidden, heads=a.heads, dtype=dtype,
    )
    return prepare(cfg, data)[:2]


def _ref_reduce(w, src, dst, weight, num_dst):
    """Plain weighted gather + scatter-add over a COO entry list."""
    import jax.numpy as jnp

    msgs = jnp.take(w.astype(jnp.float32), src, axis=0, mode="clip")
    return jnp.zeros((num_dst, w.shape[1]), jnp.float32).at[dst].add(
        msgs * weight[:, None], mode="drop"
    )


def exchange_cases(inc):
    """(name, got_fn, ref_fn, num_src, row_mask) for dir_spmm in both
    directions, unsplit (weighted, the DeepSets use) and self-loop split
    (unweighted, the PMA use). Split outputs and inputs use the N-slot
    layout (graph/incidence.py): the reference runs over the full
    incidence and is mapped into that layout; hole rows are masked."""
    import jax.numpy as jnp
    import numpy as np

    from allset_tpu.ops.exchange import dir_spmm

    mask = inc.mask.astype(jnp.float32)
    wnorm = inc.norm * mask
    N, E = inc.num_nodes, inc.num_edges
    cases = []

    d = inc.v2e()
    cases.append(("dir_spmm v2e unsplit",
                  lambda w, d=d: dir_spmm(w, d, norm=d.norm),
                  lambda w: _ref_reduce(w, inc.node, inc.edge, wnorm, E),
                  N, None))
    d = inc.e2v()
    cases.append(("dir_spmm e2v unsplit",
                  lambda w, d=d: dir_spmm(w, d, norm=d.norm),
                  lambda w: _ref_reduce(w, inc.edge, inc.node, wnorm, N),
                  E, None))
    if inc.real is not None:
        rE = inc.real.num_edges
        sl_node = np.asarray(inc.sl_node)
        boundary = E - inc.num_sl_edges
        # slot v of the N-slot layout <-> full edge id of v's self-loop
        slot_edge = np.full(N, E, np.int64)  # E: out of range (hole)
        slot_edge[sl_node] = boundary + np.arange(inc.num_sl_edges)
        full_of_slot = jnp.asarray(np.concatenate([np.arange(rE), slot_edge]))
        rows = np.concatenate([np.ones(rE, bool), np.asarray(inc.sl_mask) > 0])
        d = inc.v2e_split()

        def ref_v2e_split(w):
            full = _ref_reduce(w, inc.node, inc.edge, mask, E)
            return jnp.take(full, full_of_slot, axis=0, mode="fill",
                            fill_value=0.0)

        cases.append(("dir_spmm v2e split (N-slot)",
                      lambda w, d=d: dir_spmm(w, d), ref_v2e_split, N, rows))
        d = inc.e2v_split()
        # full edge table from the N-slot table: edge e <- slot row
        slot_of_full = np.arange(E)
        slot_of_full[boundary:] = rE + sl_node
        slot_of_full = jnp.asarray(slot_of_full)

        def ref_e2v_split(w):
            wf = jnp.take(w, slot_of_full, axis=0)
            return _ref_reduce(wf, inc.edge, inc.node, mask, N)

        cases.append(("dir_spmm e2v split (N-slot)",
                      lambda w, d=d: dir_spmm(w, d), ref_e2v_split,
                      rE + N, None))
    return cases


def _grad_pair(got_fn, ref_fn, w, t):
    import jax
    import jax.numpy as jnp

    g = jax.grad(lambda w: jnp.sum(got_fn(w).astype(jnp.float32) * t))(w)
    r = jax.grad(lambda w: jnp.sum(ref_fn(w) * t))(w.astype(jnp.float32))
    return g, r


def ref_segment_softmax(s, ids, mask, num):
    import jax.numpy as jnp

    s = jnp.where(mask[:, None], s, -jnp.inf)
    m = jnp.full((num, s.shape[1]), -jnp.inf).at[ids].max(s, mode="drop")
    e = jnp.where(mask[:, None],
                  jnp.exp(s - jnp.take(m, ids, axis=0, mode="clip")), 0.0)
    den = jnp.zeros((num, s.shape[1])).at[ids].add(e, mode="drop")
    return e / jnp.maximum(jnp.take(den, ids, axis=0, mode="clip"), 1e-30)


def ref_pma(params, x, inc, heads, eps=1e-5):
    """Plain reference PMA (reference ``src/layers.py:42-199``):
    per-segment softmax of leaky_relu(<x_K, seed>) per head, weighted
    sum of x_V, seed residual, ln0, rFF (relu MLP), relu residual, ln1."""
    import jax
    import jax.numpy as jnp

    p = params
    xK = x @ p["lin_K"]["kernel"] + p["lin_K"]["bias"]
    xV = x @ p["lin_V"]["kernel"] + p["lin_V"]["bias"]
    N, HC = xV.shape
    C = HC // heads
    seed = p["att_r"].reshape(1, heads, C)
    alpha = (xK.reshape(N, heads, C) * seed).sum(-1)
    alpha = jnp.where(alpha >= 0, alpha, 0.2 * alpha)
    a_j = jnp.take(alpha, inc.node, axis=0, mode="clip")
    w = ref_segment_softmax(a_j, inc.edge, inc.mask, inc.num_edges)
    v_j = jnp.take(xV, inc.node, axis=0, mode="clip").reshape(-1, heads, C)
    out = jnp.zeros((inc.num_edges, heads, C)).at[inc.edge].add(
        v_j * w[:, :, None], mode="drop").reshape(-1, HC)
    out = out + seed.reshape(1, HC)

    def ln(z, q):
        mu = z.mean(-1, keepdims=True)
        var = ((z - mu) ** 2).mean(-1, keepdims=True)
        return (z - mu) / jnp.sqrt(var + eps) * q["scale"] + q["bias"]

    z = ln(out, p["ln0"])
    rff = p["rFF"]
    h = z
    n_lin = len(rff)
    for i in range(n_lin):
        h = h @ rff[f"lin{i}"]["kernel"] + rff[f"lin{i}"]["bias"]
        if i < n_lin - 1:
            h = jax.nn.relu(h)
    return ln(z + jax.nn.relu(h), p["ln1"])


def phase_ops(dname: str) -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from allset_tpu.nn.modules import PMA
    from allset_tpu.ops import segment_softmax
    from allset_tpu.ops.fold import fold_gather, fold_segsum

    _, batch = build_flagship(dname, "float32")
    inc = batch.inc
    hid, heads = 256, 8
    F = hid + heads  # the packed PMA exchange width [values | denominators]
    print(f"[ops] graph: {inc.num_nodes} nodes, {inc.num_edges} hyperedges "
          f"({inc.num_sl_edges} self-loops), nnz {inc.nnz} "
          f"(padded {inc.nnz_padded}); exchange width {F}")
    ck = Checks("ops")
    rng = np.random.default_rng(0)
    hi = jax.default_matmul_precision("highest")

    for name, got_fn, ref_fn, n_src, rows in exchange_cases(inc):
        w32 = jnp.asarray(rng.normal(size=(n_src, F)).astype(np.float32))
        for dt, tol in (("float32", TOL_F32_HIGHEST), ("bfloat16", TOL_BF16)):
            w = w32.astype(dt)
            with hi:
                want = jax.jit(ref_fn)(w)
            got = jax.jit(got_fn)(w)
            ck.close(f"{name} fwd {dt}", got, want, tol, rows)
            t = jnp.asarray(rng.normal(size=want.shape).astype(np.float32))
            if rows is not None:
                t = t * jnp.asarray(rows, jnp.float32)[:, None]
            with hi:
                g, r = jax.jit(lambda w, t: _grad_pair(got_fn, ref_fn, w, t))(w, t)
            ck.close(f"{name} grad {dt}", g, r, tol)

    H = heads
    s = jnp.asarray(rng.normal(size=(inc.nnz_padded, H)).astype(np.float32))
    got_sm = lambda s: segment_softmax(s, inc.edge, inc.num_edges,
                                       mask=inc.mask, indices_are_sorted=True)
    ref_sm = lambda s: ref_segment_softmax(s, inc.edge, inc.mask,
                                           inc.num_edges)
    valid = np.asarray(inc.mask)
    with hi:
        want = jax.jit(ref_sm)(s)
    ck.close("segment_softmax fwd float32", jax.jit(got_sm)(s), want,
             TOL_F32_HIGHEST, valid)
    t = jnp.asarray(rng.normal(size=s.shape).astype(np.float32)) \
        * inc.mask[:, None]
    with hi:
        g, r = jax.jit(lambda s, t: _grad_pair(got_sm, ref_sm, s, t))(s, t)
    ck.close("segment_softmax grad float32", g, r, TOL_F32_HIGHEST, valid)

    # fold.py primitives under vmap (R = 2 statistical runs)
    R = 2
    tables = jnp.asarray(
        rng.normal(size=(R, inc.num_nodes, F)).astype(np.float32))
    got = jax.jit(jax.vmap(lambda tb: fold_gather(tb, inc.node)))(tables)
    want = jax.jit(jax.vmap(
        lambda tb: jnp.take(tb, inc.node, axis=0, mode="clip")))(tables)
    ck.close("fold_gather vmap R=2", got, want, TOL_F32_HIGHEST)
    msgs = jnp.asarray(
        rng.normal(size=(R, inc.nnz_padded, F)).astype(np.float32))
    got = jax.jit(jax.vmap(
        lambda m: fold_segsum(m, inc.edge, inc.num_edges)))(msgs)
    want = jax.jit(jax.vmap(lambda m: jax.ops.segment_sum(
        m, inc.edge, num_segments=inc.num_edges)))(msgs)
    ck.close("fold_segsum vmap R=2", got, want, TOL_F32_HIGHEST)
    name, got_fn, ref_fn, n_src, _ = exchange_cases(inc)[0]
    ws = jnp.asarray(rng.normal(size=(R, n_src, F)).astype(np.float32))
    ts = jnp.asarray(rng.normal(size=(R, inc.num_edges, F)).astype(np.float32))
    with hi:
        g, r = jax.jit(jax.vmap(
            lambda w, t: _grad_pair(got_fn, ref_fn, w, t)))(ws, ts)
    ck.close(f"{name} grad under vmap R=2", g, r, TOL_F32_HIGHEST)

    # PMA forward at flagship width over the unsplit V2E direction
    x = jnp.asarray(rng.normal(size=(inc.num_nodes, hid)).astype(np.float32))
    d = inc.v2e()
    for dt, prec, tol in (("float32", "highest", TOL_F32_HIGHEST),
                          ("float32", "default", TOL_F32_DEFAULT),
                          ("bfloat16", "default", TOL_BF16)):
        pma = PMA(hid_dim=hid, out_dim=hid, num_layers=2, heads=heads,
                  dtype=None if dt == "float32" else jnp.bfloat16)
        v = pma.init({"params": jax.random.PRNGKey(0)}, x, d)
        with jax.default_matmul_precision(prec):
            got = jax.jit(lambda v, x: pma.apply(v, x, d))(v, x)
        with hi:
            want = jax.jit(lambda p, x: ref_pma(p, x, inc, heads))(v["params"], x)
        ck.close(f"PMA fwd {dt} ({prec} precision)", got, want, tol)
    ck.done()
    xla_timings(batch)


# --- XLA timings ----------------------------------------------------------------


def device_time(fn, *args, n: int = 20) -> float:
    """Seconds per call: warm (compile) twice, then ``n`` back-to-back calls
    ended by one block_until_ready, so launches overlap device work."""
    import jax

    jax.block_until_ready(fn(*args))
    jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    out = None
    for _ in range(n):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / n


def xla_timings(batch) -> None:
    """Times of the XLA paths a Hopper kernel would have to beat: the
    sorted segment reduce at the packed PMA width over the V2E split
    direction, and the PMA epilogue at that direction's output rows."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from allset_tpu.nn import core
    from allset_tpu.nn.modules import head_normalize, pma_epilogue
    from allset_tpu.ops.exchange import dir_reduce, dir_spmm

    inc = batch.inc
    hid, heads = 256, 8
    F = hid + heads
    d = inc.v2e_split() if inc.real is not None else inc.v2e()
    nnz = d.src.shape[0]
    M = d.num_dst_total or d.num_dst
    rng = np.random.default_rng(1)

    class Epilogue(core.Module):
        dtype: object = None

        @core.compact
        def __call__(self, agg):
            seed = self.param("seed", jax.nn.initializers.normal(), (hid,))
            out, _ = head_normalize(agg, heads)
            return pma_epilogue(out, seed, hid, 2, self.dtype, relu=True,
                                train=True)

    bwd = jax.jit(lambda vjp_fn, g: vjp_fn(g))
    for dt in ("bfloat16", "float32"):
        msgs = jnp.asarray(rng.normal(size=(nnz, F)), dt)
        red = jax.jit(lambda m: dir_reduce(m, d, "add"))
        out, vjp_red = jax.vjp(lambda m: dir_reduce(m, d, "add"), msgs)
        t_f = device_time(red, msgs)
        t_b = device_time(bwd, vjp_red, jnp.ones_like(out))
        print(f"[time] sorted segment reduce {dt} [{nnz}x{F}] -> "
              f"[{d.num_dst}x{F}]: fwd {t_f * 1e3:.4f} ms, "
              f"bwd {t_b * 1e3:.4f} ms")
        w = jnp.asarray(rng.normal(size=(d.num_src, F)), dt)
        spmm = jax.jit(lambda w: dir_spmm(w, d))
        out, vjp_sp = jax.vjp(lambda w: dir_spmm(w, d), w)
        t_f = device_time(spmm, w)
        t_b = device_time(bwd, vjp_sp, jnp.ones_like(out))
        print(f"[time] dir_spmm v2e split {dt} [{d.num_src}x{F}] -> "
              f"[{M}x{F}]: fwd {t_f * 1e3:.4f} ms, bwd {t_b * 1e3:.4f} ms")

        epi = Epilogue(dtype=None if dt == "float32" else jnp.bfloat16)
        agg = jnp.abs(jnp.asarray(rng.normal(size=(M, F)), dt))
        v = epi.init({"params": jax.random.PRNGKey(0)}, agg)
        fwd = jax.jit(lambda v, a: epi.apply(v, a))
        out, vjp_epi = jax.vjp(lambda v, a: epi.apply(v, a), v, agg)
        t_f = device_time(fwd, v, agg)
        t_b = device_time(bwd, vjp_epi, jnp.ones_like(out))
        print(f"[time] PMA epilogue {dt} [{M}x{F}] -> [{M}x{hid}]: "
              f"fwd {t_f * 1e3:.4f} ms, bwd {t_b * 1e3:.4f} ms")


# --- train ----------------------------------------------------------------------


def phase_train(dname: str) -> None:
    import jax
    import numpy as np

    from allset_tpu import cli

    compile_s = []
    jax.monitoring.register_event_duration_secs_listener(
        lambda event, secs, **kw: compile_s.append(secs)
        if event == "/jax/core/compile/backend_compile_duration" else None
    )
    common = ["--dname", dname, "--epochs", "5", "--runs", "2"]
    legs = [
        ("AllSetTransformer float32",
         FLAGSHIP_ARGS + common + ["--dtype", "float32"]),
        ("AllSetTransformer bfloat16",
         FLAGSHIP_ARGS + common + ["--dtype", "bfloat16"]),
        ("HCHA float32",
         ["--method", "HCHA", "--MLP_hidden", "256", "--All_num_layers", "2"]
         + common),
    ]
    failed = []
    for name, argv in legs:
        compile_s.clear()
        t0 = time.perf_counter()
        res = cli.run(argv)
        wall = time.perf_counter() - t0
        m = np.asarray(res.metrics)  # [runs, epochs, 6]; [..., 3] = train loss
        finite = bool(np.isfinite(m).all())
        first, last = m[:, 0, 3].mean(), m[:, -1, 3].mean()
        falls = bool(last < first)
        peak = (jax.devices()[0].memory_stats() or {}).get(
            "peak_bytes_in_use", 0)
        ok = finite and falls
        print(f"[train] {name}: compile {sum(compile_s):.2f} s, wall "
              f"{wall:.2f} s, peak device memory {peak / 2**30:.3f} GiB, "
              f"train loss {first:.4f} -> {last:.4f}, metrics finite "
              f"{finite} {'ok' if ok else 'FAIL'}")
        if not ok:
            failed.append(name)
    if failed:
        raise PhaseFailed(f"training legs failed: {failed}")


# --- four cards -----------------------------------------------------------------

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter",
               "collective-permute", "all-to-all")


def collective_counts(compiled_text: str) -> dict:
    import re

    out = {}
    for op in COLLECTIVES:
        n = len(re.findall(rf" {op}(?:-start)?\(", compiled_text))
        if n:
            out[op] = n
    return out


def collective_times(trace_dir: str) -> dict:
    """Device time (ms) of each collective kind in a profiler trace,
    summed over the device planes, per profiler line (XLA ops and the
    NCCL kernels that run them sit on different lines)."""
    import glob

    import jax

    files = glob.glob(f"{trace_dir}/**/*.xplane.pb", recursive=True)
    out = {}
    if not files:
        return out
    data = jax.profiler.ProfileData.from_file(files[0])
    for plane in data.planes:
        if not plane.name.startswith("/device:"):
            continue
        for line in plane.lines:
            for ev in line.events:
                name = ev.name.lower().replace("_", "").replace("-", "")
                for op in COLLECTIVES:
                    if op.replace("-", "") in name:
                        key = f"{line.name}:{op}"
                        out[key] = out.get(key, 0.0) + ev.duration_ns / 1e6
    return {k: round(v, 4) for k, v in out.items()}


def _leaf_errs(g, ref) -> dict:
    """Per-leaf max |g - ref| over the leaf's own max |ref|."""
    import jax
    import numpy as np

    out = {}
    for path, r in jax.tree_util.tree_leaves_with_path(ref):
        leaf = np.asarray(dict(jax.tree_util.tree_leaves_with_path(g))[path])
        r = np.asarray(r)
        out[jax.tree_util.keystr(path)] = (
            float(np.abs(leaf - r).max()) / max(float(np.abs(r).max()), 1e-30)
        )
    return out


def phase_four_cards(dname: str, n: int = 4) -> None:
    """One loss-and-gradient step of the flagship through both mesh routes,
    each compared with the same step on device 0, at "highest" and at
    default matmul precision. The gradient is compared as one flattened
    vector against the tolerance of its precision (relative to its largest
    magnitude); per-parameter errors are printed beside the one-card
    step's own run-to-run difference (scatter-add atomics change the
    summation order between runs)."""
    import dataclasses
    import shutil

    import jax
    import jax.numpy as jnp

    from allset_tpu.parallel.mesh import make_mesh, replicate, shard_batch
    from allset_tpu.parallel.sharded import ShardedExchange
    from allset_tpu.train.trainer import masked_nll

    devs = jax.devices()[:n]
    model, batch = build_flagship(dname, "float32")
    params = model.init({"params": jax.random.PRNGKey(0)}, batch, False)["params"]

    def loss_fn(p, b):
        logits = model.apply({"params": p}, b, False)
        return masked_nll(logits, b.y, jnp.arange(b.num_nodes) % 2 == 0)

    step = jax.jit(jax.value_and_grad(loss_fn))
    vec = lambda g: jnp.concatenate(
        [jnp.ravel(x) for x in jax.tree_util.tree_leaves(g)])
    ck = Checks("four_cards")
    one = jax.device_put((params, batch), devs[0])
    mesh = make_mesh(n, devices=devs)
    b_g = shard_batch(batch, mesh)
    p_r = replicate(params, mesh)
    shex = ShardedExchange.build(batch.inc, mesh).shard()
    b_s = dataclasses.replace(b_g, shex=shex)
    for prec, tol in (("highest", TOL_F32_HIGHEST),
                      ("default", TOL_F32_DEFAULT)):
        with jax.default_matmul_precision(prec):
            loss1, g1 = jax.block_until_ready(step(*one))
            t0 = time.perf_counter()
            _, g1b = jax.block_until_ready(step(*one))
            dt = time.perf_counter() - t0
            noise = _leaf_errs(g1b, g1)
            print(f"[four_cards] one card (device 0), {prec} precision: loss "
                  f"{float(loss1):.6f}, step {dt * 1e3:.3f} ms; run-to-run "
                  f"gradient difference up to {max(noise.values()):.2e} "
                  f"of a parameter's max")
            for route, b in (("GSPMD", b_g), ("ShardedExchange", b_s)):
                with mesh:
                    loss, g = jax.block_until_ready(step(p_r, b))
                    t0 = time.perf_counter()
                    jax.block_until_ready(step(p_r, b))
                    dt = time.perf_counter() - t0
                    extra = ""
                    if prec == "highest":
                        text = step.lower(p_r, b).compile().as_text()
                        tdir = os.path.join(HERE, ".traces",
                                            f"four_cards_{route}")
                        shutil.rmtree(tdir, ignore_errors=True)
                        with jax.profiler.trace(tdir):
                            jax.block_until_ready(step(p_r, b))
                        extra = (f", collectives per step "
                                 f"{collective_counts(text)}, device ms per "
                                 f"step summed over cards "
                                 f"{collective_times(tdir)}")
                print(f"[four_cards] {route}, {prec} precision: loss "
                      f"{float(loss):.6f}, step {dt * 1e3:.3f} ms{extra}")
                ck.close(f"{route} loss vs one card ({prec})", loss, loss1, tol)
                ck.close(f"{route} gradient vector vs one card ({prec})",
                         vec(g), vec(g1), tol)
                errs = _leaf_errs(g, g1)
                for k in sorted(errs, key=errs.get, reverse=True)[:5]:
                    print(f"[four_cards]   {route} {prec} {k}: {errs[k]:.2e} "
                          f"of its max (one card vs itself {noise[k]:.2e})")
    ck.done()


# --- main -----------------------------------------------------------------------


def main(argv=None) -> int:
    args = parse_args(argv)
    sys.path.insert(0, HERE)
    try:
        from allset_tpu.utils.compile_cache import enable_compile_cache
    except ImportError as e:
        print(f"chip_smoke.py: cannot import the program beside this script "
              f"({e})", file=sys.stderr)
        return 1
    enable_compile_cache()  # before the first compilation
    device = None
    for ph in phases(args):
        t0 = time.perf_counter()
        print(f"== phase {ph}", flush=True)
        try:
            if ph == "device":
                device = phase_device(args.chips)
            elif ph == "ops":
                phase_ops(DNAME)
            elif ph == "train":
                phase_train(DNAME)
            elif ph == "four_cards":
                phase_four_cards(DNAME, args.chips)
        except PhaseFailed as e:
            print(f"== phase {ph} FAILED: {e}", flush=True)
            print(f"chip_smoke.py: phase {ph} failed: {e}", file=sys.stderr)
            return 1
        print(f"== phase {ph} ok ({time.perf_counter() - t0:.1f} s)",
              flush=True)
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
