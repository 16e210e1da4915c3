"""Per-layer parity tests: PMA / HalfNLHconv / SetGNN vs independent dense
numpy oracles implementing the reference math (SURVEY.md §4 implication (2)).

The oracles are written from the documented equations (GMT Eq.(7), Deep
Sets rho(sum phi(x))), not from the reference code, and use dense per-
segment loops — the polar opposite execution strategy from the segment
kernels under test.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from allset_tpu.graph import add_self_loops, norm_construction
from allset_tpu.graph.batch import Batch
from allset_tpu.graph.incidence import Direction
from allset_tpu.models.setgnn import SetGNN, SetGNNConfig
from allset_tpu.nn.modules import MLP, PMA, HalfNLHconv

from conftest import make_random_hyperdata


def layer_norm(x, eps=1e-5):
    mu = x.mean(-1, keepdims=True)
    var = x.var(-1, keepdims=True)
    return (x - mu) / np.sqrt(var + eps)


def mlp_oracle(params, x, num_layers):
    """MLP with Normalization='None', dropout 0 (the rFF config)."""
    h = x
    for i in range(num_layers - 1):
        p = params[f"lin{i}"]
        h = h @ np.asarray(p["kernel"]) + np.asarray(p["bias"])
        h = np.maximum(h, 0)
    p = params[f"lin{num_layers - 1}"]
    return h @ np.asarray(p["kernel"]) + np.asarray(p["bias"])


def pma_oracle(params, x, src, dst, num_segments, heads, hid_dim, num_layers):
    """Dense PMA: per-segment softmax pooling with a learned seed."""
    H, C = heads, hid_dim // heads
    WK, bK = np.asarray(params["lin_K"]["kernel"]), np.asarray(params["lin_K"]["bias"])
    WV, bV = np.asarray(params["lin_V"]["kernel"]), np.asarray(params["lin_V"]["bias"])
    att_r = np.asarray(params["att_r"])  # (1, H, C)

    xK = (x @ WK + bK).reshape(-1, H, C)
    xV = (x @ WV + bV).reshape(-1, H, C)
    alpha = (xK * att_r).sum(-1)  # [N, H]

    out = np.zeros((num_segments, H, C))
    for m in range(num_segments):
        entries = np.where(dst == m)[0]
        if len(entries) == 0:
            continue
        a = alpha[src[entries]]  # [k, H]
        a = np.where(a > 0, a, 0.2 * a)  # leaky_relu(0.2)
        a = a - a.max(axis=0, keepdims=True)
        p = np.exp(a) / np.exp(a).sum(axis=0, keepdims=True)
        out[m] = (p[:, :, None] * xV[src[entries]]).sum(axis=0)

    out = out + att_r
    z = layer_norm(out.reshape(num_segments, H * C))
    # ln params start at scale=1, bias=0 so fresh-init LN is just normalize
    rff = mlp_oracle(params["rFF"], z, num_layers)
    return layer_norm(z + np.maximum(rff, 0))


@pytest.mark.parametrize("heads", [1, 4])
def test_pma_matches_dense_oracle(rng, heads):
    n, m, f, hid = 40, 15, 12, 64
    nnz = 150
    src = rng.integers(0, n, size=nnz)
    dst = np.sort(rng.integers(0, m, size=nnz))
    x = rng.normal(size=(n, f)).astype(np.float32)
    # pad like Incidence does
    pad = 26
    src_p = np.concatenate([src, np.full(pad, n)]).astype(np.int32)
    dst_p = np.concatenate([dst, np.full(pad, m)]).astype(np.int32)
    mask = np.arange(nnz + pad) < nnz

    d = Direction.plain(
        jnp.asarray(src_p), jnp.asarray(dst_p), mask=jnp.asarray(mask),
        num_src=n, num_dst=m, dst_is_sorted=True,
    )
    pma = PMA(hid_dim=hid, out_dim=hid, num_layers=2, heads=heads)
    variables = pma.init(jax.random.PRNGKey(0), jnp.asarray(x), d)
    got = np.asarray(pma.apply(variables, jnp.asarray(x), d))
    want = pma_oracle(variables["params"], x, src, dst, m, heads, hid, 2)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("aggr", ["add", "mean"])
def test_halfnlh_deepsets_matches_oracle(rng, aggr):
    n, m, f, hid = 30, 10, 8, 32
    nnz = 80
    src = rng.integers(0, n, size=nnz).astype(np.int32)
    dst = np.sort(rng.integers(0, m, size=nnz)).astype(np.int32)
    norm = rng.normal(size=nnz).astype(np.float32)
    x = rng.normal(size=(n, f)).astype(np.float32)
    mask = np.ones(nnz, dtype=bool)

    d = Direction.plain(
        jnp.asarray(src), jnp.asarray(dst), norm=jnp.asarray(norm),
        mask=jnp.asarray(mask), num_src=n, num_dst=m, dst_is_sorted=True,
    )
    conv = HalfNLHconv(
        hid_dim=hid, out_dim=hid, num_layers=2, dropout=0.0,
        normalization="ln", input_norm=True, attention=False,
    )
    variables = conv.init(jax.random.PRNGKey(0), jnp.asarray(x), d, aggr)
    got = np.asarray(conv.apply(variables, jnp.asarray(x), d, aggr))

    # oracle: relu(f_enc) -> propagate -> relu(f_dec), dense
    def mlp_ln(params, h, num_layers, input_norm):
        if input_norm:
            h = layer_norm(h)
        for i in range(num_layers - 1):
            p = params[f"lin{i}"]
            h = np.maximum(h @ np.asarray(p["kernel"]) + np.asarray(p["bias"]), 0)
            h = layer_norm(h)
        p = params[f"lin{num_layers - 1}"]
        return h @ np.asarray(p["kernel"]) + np.asarray(p["bias"])

    h = np.maximum(mlp_ln(variables["params"]["f_enc"], x, 2, True), 0)
    agg = np.zeros((m, hid))
    cnt = np.zeros(m)
    for s, d, w in zip(src, dst, norm):
        agg[d] += w * h[s]
        cnt[d] += 1
    if aggr == "mean":
        agg /= np.maximum(cnt, 1)[:, None]
    want = np.maximum(mlp_ln(variables["params"]["f_dec"], agg, 2, True), 0)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


def build_inc(rng, **kw):
    hd = make_random_hyperdata(rng, **kw)
    hd = norm_construction(add_self_loops(hd), "all_one")
    return hd, hd.to_incidence()


def test_setgnn_padding_invariance(rng):
    """Output must be identical for any padding bucket (the static-shape
    discipline must not perturb the math)."""
    hd, _ = build_inc(rng)
    cfg = SetGNNConfig(num_features=16, num_classes=3, heads=4, mlp_hidden=64)
    model = SetGNN(cfg)
    b_small = Batch.from_hyperdata(hd, bucket=8)
    b_big = Batch.from_hyperdata(hd, bucket=512)
    variables = model.init(jax.random.PRNGKey(0), b_small, False)
    out_small = model.apply(variables, b_small, False)
    out_big = model.apply(variables, b_big, False)
    np.testing.assert_allclose(
        np.asarray(out_small), np.asarray(out_big), rtol=1e-5, atol=1e-5
    )


def test_setgnn_variants_forward(rng):
    hd, _ = build_inc(rng)
    batch = Batch.from_hyperdata(hd)
    for cfg in [
        SetGNNConfig(num_features=16, num_classes=3, heads=2),
        SetGNNConfig.all_deep_sets(num_features=16, num_classes=3),
        SetGNNConfig(num_features=16, num_classes=3, gpr=True),
        SetGNNConfig(num_features=16, num_classes=3, learn_mask=True),
        SetGNNConfig(num_features=16, num_classes=3, all_num_layers=0),
    ]:
        model = SetGNN(cfg)
        variables = model.init(jax.random.PRNGKey(0), batch, False)
        out = model.apply(variables, batch, False)
        assert out.shape == (hd.num_nodes, 3)
        assert np.all(np.isfinite(np.asarray(out)))


def test_setgnn_jit_and_grad(rng):
    hd, _ = build_inc(rng)
    batch = Batch.from_hyperdata(hd)
    cfg = SetGNNConfig(num_features=16, num_classes=3, heads=4)
    model = SetGNN(cfg)
    y = jnp.asarray(hd.y)
    variables = model.init(jax.random.PRNGKey(0), batch, False)

    @jax.jit
    def loss_fn(params):
        out = model.apply({"params": params}, batch, False)
        logp = jax.nn.log_softmax(out, axis=-1)
        return -jnp.take_along_axis(logp, y[:, None], axis=1).mean()

    g = jax.grad(loss_fn)(variables["params"])
    leaves = jax.tree_util.tree_leaves(g)
    assert all(np.all(np.isfinite(np.asarray(l))) for l in leaves)
    # gradients flow to the attention seed and K/V projections
    assert float(jnp.abs(g["V2E_0"]["prop"]["att_r"]).sum()) > 0
    assert float(jnp.abs(g["V2E_0"]["prop"]["lin_K"]["kernel"]).sum()) > 0


def test_pma_softmax_modes_agree(rng):
    """The 'global' stabilizer must match the reference 'segment' form to
    float precision for realistic score magnitudes."""
    n, m, hid = 40, 15, 64
    nnz = 150
    src = rng.integers(0, n, size=nnz).astype(np.int32)
    dst = np.sort(rng.integers(0, m, size=nnz)).astype(np.int32)
    x = (rng.normal(size=(n, 12)) * 3).astype(np.float32)
    mask = np.ones(nnz, dtype=bool)

    d = Direction.plain(
        jnp.asarray(src), jnp.asarray(dst), mask=jnp.asarray(mask),
        num_src=n, num_dst=m, dst_is_sorted=True,
    )
    outs = {}
    for mode in ("segment", "global"):
        pma = PMA(hid_dim=hid, out_dim=hid, num_layers=2, heads=4, softmax_mode=mode)
        variables = pma.init(jax.random.PRNGKey(7), jnp.asarray(x), d)
        outs[mode] = np.asarray(pma.apply(variables, jnp.asarray(x), d))
    np.testing.assert_allclose(outs["segment"], outs["global"], rtol=1e-4, atol=1e-5)


def test_pma_return_attention_sums_to_one(rng):
    """return_attention parity API (reference src/layers.py:159-164):
    per-entry softmax weights must sum to 1 over each destination."""
    import jax
    import jax.numpy as jnp

    from allset_tpu.graph.incidence import Incidence
    from allset_tpu.nn.modules import PMA

    n, m, nnz = 30, 12, 100
    node = rng.integers(0, n, size=nnz)
    edge = np.sort(rng.integers(0, m, size=nnz))
    inc = Incidence.from_arrays(node, edge, num_nodes=n, num_edges=m,
                                bucket=128)
    d = inc.v2e()
    pma = PMA(hid_dim=16, out_dim=16, num_layers=2, heads=4, return_attention=True)
    x = jnp.asarray(rng.normal(size=(n, 16)).astype(np.float32))
    v = pma.init({"params": jax.random.PRNGKey(0)}, x, d)
    out, attn = pma.apply(v, x, d)
    assert out.shape == (m, 16)
    sums = np.zeros((m, 4))
    an = np.asarray(attn)
    for i, (dst, ok) in enumerate(zip(np.asarray(d.dst), np.asarray(d.mask))):
        if ok:
            sums[dst] += an[i]
    present = np.unique(np.asarray(d.dst)[np.asarray(d.mask)])
    np.testing.assert_allclose(sums[present], 1.0, rtol=1e-4)
