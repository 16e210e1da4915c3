"""Unit tests for the segment primitives against dense numpy oracles
(SURVEY.md §4 implication (1))."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from allset_tpu.ops import (
    propagate,
    segment_max,
    segment_mean,
    segment_softmax,
    segment_sum,
)


def dense_oracle(data, seg, num_segments, reduce):
    """Dense reference: route entries into buckets in python."""
    out = np.zeros((num_segments,) + data.shape[1:], dtype=np.float64)
    counts = np.zeros(num_segments)
    if reduce == "max":
        filled = np.zeros(num_segments, dtype=bool)
        for d, s in zip(data, seg):
            if s >= num_segments:
                continue
            out[s] = np.maximum(out[s], d) if filled[s] else d
            filled[s] = True
        return out
    for d, s in zip(data, seg):
        if s >= num_segments:
            continue
        out[s] += d
        counts[s] += 1
    if reduce == "mean":
        out /= np.maximum(counts, 1)[:, None] if out.ndim > 1 else np.maximum(counts, 1)
    return out


@pytest.mark.parametrize("reduce", ["add", "mean", "max"])
@pytest.mark.parametrize("sorted_ids", [True, False])
def test_segment_reduce_matches_oracle(rng, reduce, sorted_ids):
    nnz, m, f = 200, 17, 8
    seg = rng.integers(0, m, size=nnz)
    if sorted_ids:
        seg = np.sort(seg)
    # append out-of-range padding entries: must be dropped
    seg = np.concatenate([seg, np.full(16, m)])
    data = rng.normal(size=(len(seg), f)).astype(np.float32)

    fn = {"add": segment_sum, "mean": segment_mean, "max": segment_max}[reduce]
    got = fn(jnp.asarray(data), jnp.asarray(seg), m, indices_are_sorted=sorted_ids)
    want = dense_oracle(data, seg, m, reduce)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-5, atol=1e-5)


def test_segment_sum_empty_segments(rng):
    seg = np.array([0, 0, 5])
    data = np.ones((3, 2), dtype=np.float32)
    got = np.asarray(segment_sum(jnp.asarray(data), jnp.asarray(seg), 7))
    assert got[0].sum() == 4.0
    assert got[5].sum() == 2.0
    assert got[[1, 2, 3, 4, 6]].sum() == 0.0


def test_segment_softmax_matches_oracle(rng):
    nnz, m, h = 120, 11, 4
    seg = np.sort(rng.integers(0, m, size=nnz))
    scores = rng.normal(size=(nnz, h)).astype(np.float32) * 5

    got = np.asarray(
        segment_softmax(jnp.asarray(scores), jnp.asarray(seg), m, indices_are_sorted=True)
    )
    # oracle per segment per head
    for s in range(m):
        rows = np.where(seg == s)[0]
        if len(rows) == 0:
            continue
        for head in range(h):
            e = np.exp(scores[rows, head] - scores[rows, head].max())
            np.testing.assert_allclose(got[rows, head], e / e.sum(), rtol=1e-5)
    # per-segment probabilities sum to 1
    sums = dense_oracle(got, seg, m, "add")
    present = np.unique(seg)
    np.testing.assert_allclose(sums[present], 1.0, rtol=1e-5)


def test_segment_softmax_mask_zeroes_padding(rng):
    nnz, m = 40, 5
    seg = np.concatenate([np.sort(rng.integers(0, m, size=nnz)), np.full(8, m)])
    mask = np.arange(len(seg)) < nnz
    scores = rng.normal(size=(len(seg),)).astype(np.float32)
    got = np.asarray(
        segment_softmax(jnp.asarray(scores), jnp.asarray(seg), m, mask=jnp.asarray(mask))
    )
    assert np.all(got[nnz:] == 0.0)
    assert np.all(np.isfinite(got))
    sums = dense_oracle(got, seg, m, "add")
    np.testing.assert_allclose(sums[np.unique(seg[:nnz])], 1.0, rtol=1e-5)


def test_segment_softmax_all_masked_segment_is_finite():
    # a segment whose entries are ALL masked must produce zeros, not NaN
    seg = np.array([0, 0, 1, 1])
    mask = np.array([True, True, False, False])
    scores = np.array([1.0, 2.0, 3.0, 4.0], dtype=np.float32)
    got = np.asarray(segment_softmax(jnp.asarray(scores), jnp.asarray(seg), 2, mask=jnp.asarray(mask)))
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got[2:], 0.0)


def test_propagate_matches_dense_spmm(rng):
    """propagate == SpMM with the COO incidence (the hot op)."""
    n, m, f, nnz = 30, 12, 16, 150
    src = rng.integers(0, n, size=nnz)
    dst = rng.integers(0, m, size=nnz)
    norm = rng.normal(size=nnz).astype(np.float32)
    x = rng.normal(size=(n, f)).astype(np.float32)

    got = np.asarray(
        propagate(jnp.asarray(x), jnp.asarray(src), jnp.asarray(dst), jnp.asarray(norm), m, "add")
    )
    A = np.zeros((m, n), dtype=np.float64)
    for s, d, w in zip(src, dst, norm):
        A[d, s] += w
    np.testing.assert_allclose(got, A @ x, rtol=1e-4, atol=1e-4)


def test_propagate_padding_dropped(rng):
    n, m, f = 10, 4, 3
    src = np.array([0, 1, n])  # last is padding (clamped gather)
    dst = np.array([0, 1, m])  # OOB -> dropped
    norm = np.array([1.0, 1.0, 0.0], dtype=np.float32)
    x = rng.normal(size=(n, f)).astype(np.float32)
    got = np.asarray(propagate(jnp.asarray(x), jnp.asarray(src), jnp.asarray(dst), jnp.asarray(norm), m, "add"))
    np.testing.assert_allclose(got[0], x[0], rtol=1e-6)
    np.testing.assert_allclose(got[1], x[1], rtol=1e-6)
    np.testing.assert_allclose(got[2:], 0.0)


def _sorted_inc(rng, n, m, nnz):
    """Incidence whose last segments are empty (ids drawn below m - 3) and
    whose nnz axis carries padded entries (nnz not a bucket multiple)."""
    from allset_tpu.graph.incidence import Incidence

    node = rng.integers(0, n, size=nnz)
    edge = np.sort(rng.integers(0, m - 3, size=nnz))
    inc = Incidence.from_arrays(node, edge, num_nodes=n, num_edges=m, bucket=128)
    assert inc.nnz_padded > inc.nnz
    return inc


@pytest.mark.parametrize("f", [1, 7, 130])
@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_sorted_reduce_matches_numpy(rng, f, dtype):
    """dir_reduce's sorted sum (XLA segment_sum with the sorted hint,
    float32 accumulation) matches a numpy float64 oracle at widths off
    any lane multiple; empty segments are 0 and padded entries drop."""
    from allset_tpu.ops.exchange import dir_reduce

    inc = _sorted_inc(rng, 40, 25, 300)
    d = inc.v2e()
    msgs = rng.normal(size=(inc.nnz_padded, f)).astype(np.float32)
    msgs[~np.asarray(inc.mask)] = 1e3  # padded entries must not count
    got = dir_reduce(jnp.asarray(msgs).astype(dtype), d, "add")
    assert got.shape == (25, f) and got.dtype == jnp.dtype(dtype)
    want = np.zeros((25, f))
    m_in = np.asarray(jnp.asarray(msgs).astype(dtype).astype(jnp.float32))
    for e, ok, row in zip(np.asarray(d.dst), np.asarray(d.mask), m_in):
        if ok:
            want[e] += row
    assert np.all(want[-3:] == 0)
    tol = 1e-5 if dtype == np.float32 else 2e-2
    np.testing.assert_allclose(
        np.asarray(got.astype(jnp.float32)), want,
        rtol=tol, atol=tol * np.abs(want).max(),
    )


@pytest.mark.parametrize("direction", ["v2e", "e2v"])
def test_sorted_reduce_vjp_is_row_gather(rng, direction):
    """The custom VJP of the sorted sum hands every valid entry the
    cotangent row of its segment (autodiff of segment_sum), at a
    lane-unaligned width, through both execution orders."""
    from allset_tpu.ops.exchange import dir_reduce

    inc = _sorted_inc(rng, 40, 25, 300)
    d = inc.v2e() if direction == "v2e" else inc.e2v()
    f = 5
    msgs = jnp.asarray(rng.normal(size=(inc.nnz_padded, f)).astype(np.float32))
    t = jnp.asarray(rng.normal(size=(d.num_dst, f)).astype(np.float32))

    g = jax.grad(lambda mm: (dir_reduce(mm, d, "add") * t).sum())(msgs)
    g_ref = jax.grad(
        lambda mm: (
            jax.ops.segment_sum(mm, d.dst, num_segments=d.num_dst) * t
        ).sum()
    )(msgs)
    mask = np.asarray(d.mask)
    np.testing.assert_allclose(np.asarray(g)[mask], np.asarray(g_ref)[mask],
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(np.asarray(g)[mask],
                                  np.asarray(t)[np.asarray(d.dst)[mask]])


# --- fused dir_spmm (permute-free backward) --------------------------------


def _make_inc(rng, n=60, m=24, nnz=260):
    from allset_tpu.graph.incidence import Incidence

    node = rng.integers(0, n, size=nnz)
    edge = np.sort(rng.integers(0, m, size=nnz))
    return Incidence.from_arrays(
        node, edge, norm=rng.normal(size=nnz).astype(np.float32),
        num_nodes=n, num_edges=m, bucket=128,
    )


@pytest.mark.parametrize("direction", ["v2e", "e2v"])
@pytest.mark.parametrize("use_norm", [False, True])
def test_dir_spmm_forward_matches_dense(rng, direction, use_norm):
    from allset_tpu.ops.exchange import _spmm_fused_ok, dir_spmm

    inc = _make_inc(rng)
    d = inc.v2e() if direction == "v2e" else inc.e2v()
    assert _spmm_fused_ok(d)
    w = rng.normal(size=(d.num_src, 8)).astype(np.float32)

    got = np.asarray(
        dir_spmm(jnp.asarray(w), d, norm=d.norm if use_norm else None)
    )
    A = np.zeros((d.num_dst, d.num_src))
    src, dst, norm = np.asarray(d.src), np.asarray(d.dst), np.asarray(d.norm)
    mask = np.asarray(d.mask)
    for s, t, wgt, mk in zip(src, dst, norm, mask):
        if mk:
            A[t, s] += wgt if use_norm else 1.0
    np.testing.assert_allclose(got, A @ w, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("direction", ["v2e", "e2v"])
def test_dir_spmm_grad_matches_composable(rng, direction):
    from allset_tpu.ops.exchange import dir_gather, dir_reduce, dir_spmm

    inc = _make_inc(rng)
    d = inc.v2e() if direction == "v2e" else inc.e2v()
    w = jnp.asarray(rng.normal(size=(d.num_src, 8)).astype(np.float32))
    t = jnp.asarray(rng.normal(size=(d.num_dst, 8)).astype(np.float32))

    def loss_fused(w):
        return jnp.sum((dir_spmm(w, d, norm=d.norm) - t) ** 2)

    def loss_ref(w):
        msgs = dir_gather(w, d) * d.norm[:, None]
        return jnp.sum((dir_reduce(msgs, d, "add") - t) ** 2)

    np.testing.assert_allclose(
        np.asarray(loss_fused(w)), np.asarray(loss_ref(w)), rtol=1e-4
    )
    g_f = np.asarray(jax.grad(loss_fused)(w))
    g_r = np.asarray(jax.grad(loss_ref)(w))
    np.testing.assert_allclose(g_f, g_r, rtol=1e-4, atol=1e-4)


def test_dir_spmm_norm_grad_sddmm(rng):
    """norm_grad=True: dnorm must match autodiff through the composable
    path (the LearnMask case)."""
    from allset_tpu.ops.exchange import dir_gather, dir_reduce, dir_spmm

    inc = _make_inc(rng)
    d = inc.v2e()
    w = jnp.asarray(rng.normal(size=(d.num_src, 8)).astype(np.float32))

    def loss_fused(norm):
        return jnp.sum(dir_spmm(w, d, norm=norm, norm_grad=True) ** 2)

    def loss_ref(norm):
        msgs = dir_gather(w, d) * norm[:, None]
        return jnp.sum(dir_reduce(msgs, d, "add") ** 2)

    g_f = np.asarray(jax.grad(loss_fused)(d.norm))
    g_r = np.asarray(jax.grad(loss_ref)(d.norm))
    mask = np.asarray(d.mask)
    np.testing.assert_allclose(g_f[mask], g_r[mask], rtol=1e-4, atol=1e-4)


def test_dir_spmm_mean(rng):
    from allset_tpu.ops.exchange import dir_propagate, dir_spmm

    inc = _make_inc(rng)
    d = inc.v2e()
    w = jnp.asarray(rng.normal(size=(d.num_src, 8)).astype(np.float32))
    got = np.asarray(dir_spmm(w, d, norm=d.norm, reduce="mean"))
    want = np.asarray(dir_propagate(w, d, reduce="mean"))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


# --- self-loop suffix split ------------------------------------------------


def _make_sl_inc(rng, n=50, m=20, nnz=200):
    """Incidence with Add_Self_Loops applied (suffix singleton edges)."""
    from allset_tpu.graph.transforms import HyperData, add_self_loops, coalesce, norm_construction

    node = rng.integers(0, n, size=nnz)
    edge = rng.integers(0, m, size=nnz)
    node, edge = coalesce(node, edge)
    hd = HyperData(
        x=np.zeros((n, 4), np.float32), y=np.zeros(n, np.int64),
        node=node, edge=edge, num_nodes=n, num_hyperedges=m,
    )
    hd = norm_construction(add_self_loops(hd), "deg_half_sym")
    return hd, hd.to_incidence(bucket=128)


def test_incidence_selfloop_split_structure(rng):
    hd, inc = _make_sl_inc(rng)
    assert inc.real is not None
    assert inc.num_sl_edges == hd.num_sl_edges
    assert inc.real.num_edges + inc.num_sl_edges == inc.num_edges
    assert inc.real.nnz + inc.num_sl_edges == inc.nnz
    # sl_node ascending (appended in node order)
    sl = np.asarray(inc.sl_node)
    assert np.all(np.diff(sl) > 0)


@pytest.mark.parametrize("use_norm", [False, True])
@pytest.mark.parametrize("reduce", ["add", "mean"])
def test_dir_spmm_split_matches_unsplit(rng, use_norm, reduce):
    """N-slot split (append/add) spmm == unsplit spmm over the full
    incidence, values and gradients. The append output uses the N-slot
    layout: row (num_real + v) is node v's self-loop slot."""
    from allset_tpu.ops.exchange import dir_spmm

    _, inc = _make_sl_inc(rng)
    f = 8
    n_real = inc.real.num_edges
    sl = np.asarray(inc.sl_node)  # compact self-loop edge -> node id
    n = inc.num_nodes

    # --- v2e: map N-slot rows back to compact edge ids for comparison
    dv_s, dv_f = inc.v2e_split(), inc.v2e()
    w = jnp.asarray(rng.normal(size=(dv_f.num_src, f)).astype(np.float32))
    t = jnp.asarray(rng.normal(size=(dv_f.num_dst, f)).astype(np.float32))
    # compact edge id -> N-slot row: real edges identity, sl edge j -> n_real + sl[j]
    rowmap = np.concatenate([np.arange(n_real), n_real + sl]).astype(np.int32)

    def loss_split_v(w):
        out = dir_spmm(w, dv_s, norm=dv_s.norm if use_norm else None, reduce=reduce)
        out = jnp.take(out, jnp.asarray(rowmap), axis=0)
        return jnp.sum((out - t) ** 2), out

    def loss_full_v(w):
        out = dir_spmm(w, dv_f, norm=dv_f.norm if use_norm else None, reduce=reduce)
        return jnp.sum((out - t) ** 2), out

    (_, outs), gs = jax.value_and_grad(loss_split_v, has_aux=True)(w)
    (_, outf), gf = jax.value_and_grad(loss_full_v, has_aux=True)(w)
    np.testing.assert_allclose(np.asarray(outs), np.asarray(outf), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(np.asarray(gs), np.asarray(gf), rtol=1e-4, atol=1e-5)

    # --- e2v: split consumes the N-slot edge table; build it from compact
    de_s, de_f = inc.e2v_split(), inc.e2v()
    wc = rng.normal(size=(de_f.num_src, f)).astype(np.float32)  # compact [M, f]
    wn = np.zeros((n_real + n, f), np.float32)
    wn[rowmap] = wc  # holes stay zero (masked anyway)
    t2 = jnp.asarray(rng.normal(size=(de_f.num_dst, f)).astype(np.float32))

    def loss_split_e(wn):
        out = dir_spmm(wn, de_s, norm=de_s.norm if use_norm else None, reduce=reduce)
        return jnp.sum((out - t2) ** 2), out

    def loss_full_e(wc):
        out = dir_spmm(wc, de_f, norm=de_f.norm if use_norm else None, reduce=reduce)
        return jnp.sum((out - t2) ** 2), out

    (_, outs), gs = jax.value_and_grad(loss_split_e, has_aux=True)(jnp.asarray(wn))
    (_, outf), gf = jax.value_and_grad(loss_full_e, has_aux=True)(jnp.asarray(wc))
    np.testing.assert_allclose(np.asarray(outs), np.asarray(outf), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(np.asarray(gs)[rowmap], np.asarray(gf), rtol=1e-4, atol=1e-5)


def test_dir_spmm_split_unweighted_ignores_slnorm(rng):
    """norm=None (the PMA path) must leave self-loop slot rows unscaled
    even when the incidence carries non-trivial norms."""
    from allset_tpu.ops.exchange import dir_spmm

    _, inc = _make_sl_inc(rng)
    d = inc.v2e_split()
    w = jnp.asarray(rng.normal(size=(d.num_src, 8)).astype(np.float32))
    out = np.asarray(dir_spmm(w, d))
    np.testing.assert_allclose(out[d.num_dst :], np.asarray(w), rtol=1e-5)
