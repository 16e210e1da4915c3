"""Per-layer numeric oracle parity for the baseline-zoo convs
(SURVEY.md §4 implication (2)).

Each oracle is an independent dense-numpy implementation of the
reference equations — HypergraphConv incl. symdegnorm and the attention
path (``src/layers.py:398-494``), HNHNConv (``src/layers.py:260-311`` +
norm builders ``src/preprocessing.py:295-340``), UniGCNIIConv identity
mapping (``src/models.py:911-944``), UniGATConv (``src/models.py:
818-854``), and the DGL-style GATConv of the HAN vertical
(``src/DGL_HAN/model.py:54``) — executed as dense matrix products and
per-segment python loops, the polar opposite strategy from the sorted
segment kernels under test. A passing test pins norm placement,
direction order, and degree math, which learns-above-chance tests
cannot."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from allset_tpu.graph.batch import Batch
from allset_tpu.graph.incidence import Incidence

from conftest import make_random_hyperdata


def leaky(x, s=0.2):
    return np.where(x > 0, x, s * x)


def dense_H(hd):
    H = np.zeros((hd.num_nodes, hd.num_hyperedges), np.float64)
    H[hd.node, hd.edge] = 1.0
    return H


@pytest.fixture
def hd(rng):
    return make_random_hyperdata(rng, num_nodes=30, num_hyperedges=18,
                                 avg_size=4, num_features=12)


def _safe_inv(v, p=1.0):
    with np.errstate(divide="ignore"):
        inv = v ** -p
    inv[~np.isfinite(inv)] = 0.0
    return inv


@pytest.mark.parametrize("sym", [False, True])
def test_hypergraphconv_oracle(hd, sym):
    from allset_tpu.models.hcha import HypergraphConv

    batch = Batch.from_hyperdata(hd, bucket=64)
    conv = HypergraphConv(out_channels=7, symdegnorm=sym)
    v = conv.init({"params": jax.random.PRNGKey(1)}, batch.x, batch)
    got = np.asarray(conv.apply(v, batch.x, batch))

    p = v["params"]
    H = dense_H(hd)
    XW = np.asarray(batch.x, np.float64) @ np.asarray(p["weight"], np.float64)
    D = H.sum(1)
    B = _safe_inv(H.sum(0))
    if sym:
        Dn = _safe_inv(D, 0.5)
        XW = Dn[:, None] * XW
    else:
        Dn = _safe_inv(D)
    Xe = B[:, None] * (H.T @ XW)
    out = Dn[:, None] * (H @ Xe) + np.asarray(p["bias"], np.float64)
    np.testing.assert_allclose(got, out, rtol=1e-5, atol=1e-5)


def test_hypergraphconv_attention_oracle(hd):
    from allset_tpu.models.hcha import HypergraphConv

    batch = Batch.from_hyperdata(hd, bucket=64)
    Hh, F = 2, 5
    conv = HypergraphConv(out_channels=F, use_attention=True, heads=Hh,
                          dropout=0.0)
    v = conv.init({"params": jax.random.PRNGKey(2)}, batch.x, batch)
    got = np.asarray(conv.apply(v, batch.x, batch))

    p = v["params"]
    n, m = hd.num_nodes, hd.num_hyperedges
    XW = (np.asarray(batch.x, np.float64)
          @ np.asarray(p["weight"], np.float64)).reshape(n, Hh, F)
    att = np.asarray(p["att"], np.float64)  # (1, H, 2F)
    # reference quirk: x_j indexes the NODE table by hyperedge id
    # (src/layers.py:429; ids clipped into range)
    ej = np.minimum(hd.edge, n - 1)
    s = np.concatenate([XW[hd.node], XW[ej]], axis=-1)  # [nnz, H, 2F]
    alpha = leaky((s * att).sum(-1))  # [nnz, H]
    # softmax grouped by NODE (src/layers.py:433)
    aw = np.zeros_like(alpha)
    for vtx in range(n):
        e = np.where(hd.node == vtx)[0]
        if len(e) == 0:
            continue
        a = alpha[e] - alpha[e].max(axis=0, keepdims=True)
        ex = np.exp(a)
        aw[e] = ex / ex.sum(axis=0, keepdims=True)

    D = _safe_inv(np.bincount(hd.node, minlength=n).astype(np.float64))
    B = _safe_inv(np.bincount(hd.edge, minlength=m).astype(np.float64))
    # V->E then E->V, the per-entry attention weight riding both passes
    Xe = np.zeros((m, Hh, F))
    for i in range(len(hd.node)):
        Xe[hd.edge[i]] += B[hd.edge[i]] * aw[i][:, None] * XW[hd.node[i]]
    Xv = np.zeros((n, Hh, F))
    for i in range(len(hd.node)):
        Xv[hd.node[i]] += D[hd.node[i]] * aw[i][:, None] * Xe[hd.edge[i]]
    out = Xv.reshape(n, Hh * F) + np.asarray(p["bias"], np.float64)
    np.testing.assert_allclose(got, out, rtol=1e-4, atol=1e-5)


def test_hnhnconv_oracle(hd):
    from allset_tpu.graph.transforms import generate_norm_hnhn
    from allset_tpu.models.hnhn import HNHNConv

    hd2 = generate_norm_hnhn(hd, alpha=-1.5, beta=-0.5)
    batch = Batch.from_hyperdata(hd2, bucket=64)
    conv = HNHNConv(hidden_channels=9, out_channels=6)
    v = conv.init({"params": jax.random.PRNGKey(3)}, batch.x, batch)
    got = np.asarray(conv.apply(v, batch.x, batch))

    p = v["params"]
    H = dense_H(hd)
    dv, de = H.sum(1), H.sum(0)
    # norm vectors per src/preprocessing.py:295-340 (alpha=-1.5, beta=-0.5);
    # zero-degree rows never meet a nonzero H entry, so zeroing their
    # powers keeps the dense matmuls NaN-free without changing the math
    de_alpha = _safe_inv(de, 1.5)
    dv_beta = _safe_inv(dv, 0.5)
    d_v_alpha_inv = _safe_inv(H @ de_alpha)
    d_e_beta_inv = _safe_inv(H.T @ dv_beta)

    X = np.asarray(batch.x, np.float64)
    W1, b1 = np.asarray(p["weight_v2e"]["kernel"]), np.asarray(p["weight_v2e"]["bias"])
    W2, b2 = np.asarray(p["weight_e2v"]["kernel"]), np.asarray(p["weight_e2v"]["bias"])
    E = d_e_beta_inv[:, None] * (H.T @ (dv_beta[:, None] * (X @ W1 + b1)))
    E = np.maximum(E, 0.0)
    out = d_v_alpha_inv[:, None] * (H @ (de_alpha[:, None] * (E @ W2 + b2)))
    np.testing.assert_allclose(got, out, rtol=1e-4, atol=1e-5)


def test_unigcnii_conv_oracle(hd):
    from allset_tpu.graph.transforms import unignn_degrees
    from allset_tpu.models.unignn import UniGCNIIConfig, UniGCNIIConv

    degV, degE = unignn_degrees(hd)
    hd2 = hd.copy()
    hd2.extras.update(degV=degV, degE=degE)
    batch = Batch.from_hyperdata(hd2, bucket=64)
    cfg = UniGCNIIConfig(num_features=12, num_classes=3, mlp_hidden=8)
    conv = UniGCNIIConv(cfg, out_features=12)
    x = batch.x
    x0 = batch.x * 0.5
    alpha, beta = 0.1, 0.37
    v = conv.init({"params": jax.random.PRNGKey(4)}, x, x0, alpha, beta, batch)
    got = np.asarray(conv.apply(v, x, x0, alpha, beta, batch))

    H = dense_H(hd)
    dv = H.sum(1)
    # degrees per src/train.py:396-412: degE = (mean_{v in e} d_v)^-1/2,
    # degV = d_v^-1/2 (inf -> 1)
    de_cnt = np.maximum(H.sum(0), 1)
    degE_o = ((H.T @ dv) / de_cnt) ** -0.5
    degV_o = _safe_inv(dv, 0.5)
    degV_o[dv == 0] = 1.0
    np.testing.assert_allclose(degE[:, 0], degE_o, rtol=1e-6)
    np.testing.assert_allclose(degV[:, 0], degV_o, rtol=1e-6)

    X = np.asarray(x, np.float64)
    Xe = (H.T @ X) / de_cnt[:, None]  # first_aggregate='mean'
    Xe = degE_o[:, None] * Xe
    Xv = degV_o[:, None] * (H @ Xe)
    Xi = (1 - alpha) * Xv + alpha * np.asarray(x0, np.float64)
    W = np.asarray(v["params"]["W"]["kernel"], np.float64)
    out = (1 - beta) * Xi + beta * (Xi @ W)
    np.testing.assert_allclose(got, out, rtol=1e-4, atol=1e-5)


def test_unigat_conv_oracle(hd):
    from allset_tpu.models.unignn import UniGATConv, UniGNNConfig

    batch = Batch.from_hyperdata(hd, bucket=64)
    cfg = UniGNNConfig(num_features=12, num_classes=3, model_name="UniGAT",
                       attn_drop=0.0, first_aggregate="mean")
    Hh, C = 2, 5
    conv = UniGATConv(cfg, out_channels=C, heads=Hh)
    v = conv.init({"params": jax.random.PRNGKey(5)}, batch.x, batch)
    got = np.asarray(conv.apply(v, batch.x, batch))

    p = v["params"]
    n, m = hd.num_nodes, hd.num_hyperedges
    H = dense_H(hd)
    X0 = np.asarray(batch.x, np.float64) @ np.asarray(p["W"]["kernel"], np.float64)
    X = X0.reshape(n, Hh, C)
    cnt = np.maximum(H.sum(0), 1)
    Xe = np.einsum("nm,nhc->mhc", H, X) / cnt[:, None, None]  # mean
    att_e = np.asarray(p["att_e"], np.float64)
    alpha_e = (Xe * att_e).sum(-1)  # [m, H]
    a_ev = alpha_e[hd.edge]  # per entry
    al = leaky(a_ev)
    aw = np.zeros_like(al)
    for vtx in range(n):
        e = np.where(hd.node == vtx)[0]
        if len(e) == 0:
            continue
        a = al[e] - al[e].max(axis=0, keepdims=True)
        ex = np.exp(a)
        aw[e] = ex / ex.sum(axis=0, keepdims=True)
    Xv = np.zeros((n, Hh, C))
    for i in range(len(hd.node)):
        Xv[hd.node[i]] += aw[i][:, None] * Xe[hd.edge[i]]
    out = Xv.reshape(n, Hh * C)
    np.testing.assert_allclose(got, out, rtol=1e-4, atol=1e-5)


def test_dgl_gatconv_oracle(rng):
    from allset_tpu.models.han import DGLGATConv

    # combined id-space graph (HAN metapath graphs): T rows, T segments
    T, nnz = 24, 120
    src = np.sort(rng.integers(0, T, nnz)).astype(np.int32)
    dst = rng.integers(0, T, nnz).astype(np.int32)
    order = np.argsort(dst, kind="stable")
    src, dst = src[order], dst[order]
    g = Incidence.from_arrays(src, dst, num_nodes=T, num_edges=T, bucket=64)
    x = jnp.asarray(rng.normal(size=(T, 10)).astype(np.float32))

    Hh, C = 2, 6
    conv = DGLGATConv(out_channels=C, heads=Hh)
    v = conv.init({"params": jax.random.PRNGKey(6)}, g, x)
    got = np.asarray(conv.apply(v, g, x))

    p = v["params"]
    h = np.asarray(x, np.float64) @ np.asarray(p["fc"], np.float64)
    hr = h.reshape(T, Hh, C)
    el = (hr * np.asarray(p["attn_l"], np.float64)).sum(-1)  # [T, H]
    er = (hr * np.asarray(p["attn_r"], np.float64)).sum(-1)
    al = leaky(el[src] + er[dst])
    aw = np.zeros_like(al)
    for d_ in range(T):
        e = np.where(dst == d_)[0]
        if len(e) == 0:
            continue
        a = al[e] - al[e].max(axis=0, keepdims=True)
        ex = np.exp(a)
        aw[e] = ex / ex.sum(axis=0, keepdims=True)
    out = np.zeros((T, Hh, C))
    for i in range(nnz):
        out[dst[i]] += aw[i][:, None] * hr[src[i]]
    out = out.reshape(T, Hh * C)
    out = np.where(out > 0, out, np.expm1(out))  # elu
    np.testing.assert_allclose(got, out, rtol=1e-4, atol=1e-5)
