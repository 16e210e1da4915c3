"""PMA's row-local epilogue (nn/modules.head_normalize + pma_epilogue),
the unfused XLA composition the model runs, against a numpy float32
oracle of the reference math (``src/layers.py:150-157``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from allset_tpu.nn import core
from allset_tpu.nn.modules import LN_EPS, head_normalize, pma_epilogue

H, HC = 4, 32


class Epilogue(core.Module):
    num_layers: int
    dtype: object = None
    relu: bool = True

    @core.compact
    def __call__(self, agg):
        seed = self.param("seed", jax.nn.initializers.normal(1.0), (HC,))
        out, _ = head_normalize(agg, H)
        return pma_epilogue(out, seed, HC, self.num_layers, self.dtype,
                            self.relu)


def _ln(z, scale, bias):
    mu = z.mean(-1, keepdims=True)
    var = ((z - mu) ** 2).mean(-1, keepdims=True)
    return (z - mu) / np.sqrt(var + LN_EPS) * scale + bias


def oracle(p, agg, num_layers, relu=True):
    """numpy float32: per-head divide, seed residual, ln0, rFF, relu
    residual, ln1, relu."""
    agg = np.asarray(agg, np.float32)
    den = np.maximum(agg[:, HC:], 1e-16)
    out = agg[:, :HC] / np.repeat(den, HC // H, axis=1) + p["seed"]
    z = _ln(out, p["ln0"]["scale"], p["ln0"]["bias"])
    h = z
    for i in range(num_layers):
        h = h @ p["rFF"][f"lin{i}"]["kernel"] + p["rFF"][f"lin{i}"]["bias"]
        if i < num_layers - 1:
            h = np.maximum(h, 0)
    y = _ln(z + np.maximum(h, 0), p["ln1"]["scale"], p["ln1"]["bias"])
    return np.maximum(y, 0) if relu else y


def _inputs(rng, rows=50):
    agg = rng.normal(size=(rows, HC + H)).astype(np.float32)
    agg[:, HC:] = np.abs(agg[:, HC:]) + 0.1  # softmax denominators > 0
    agg[-3:, HC:] = 0.0  # empty destinations: denominator floor
    agg[-3:, :HC] = 0.0
    return agg


@pytest.mark.parametrize("num_layers", [1, 2])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_epilogue_matches_numpy(rng, num_layers, dtype):
    agg = _inputs(rng)
    mod = Epilogue(num_layers, None if dtype == "float32" else jnp.bfloat16)
    v = mod.init({"params": jax.random.PRNGKey(0)}, jnp.asarray(agg))
    p = jax.tree_util.tree_map(np.asarray, v["params"])
    got = mod.apply(v, jnp.asarray(agg).astype(dtype))
    assert got.dtype == jnp.dtype(dtype) and got.shape == (50, HC)
    want = oracle(p, np.asarray(jnp.asarray(agg).astype(dtype)
                                .astype(jnp.float32)), num_layers)
    tol = 1e-5 if dtype == "float32" else 2e-2
    err = np.abs(np.asarray(got, np.float32) - want).max() / np.abs(want).max()
    assert err <= tol, err


def test_epilogue_relu_residual_gradient(rng):
    """Gradients w.r.t. the aggregate and every parameter match autodiff
    of a plain jnp transcription of the oracle: the cotangent reaches z
    both through the residual and through relu(rFF(z))."""
    agg = jnp.asarray(_inputs(rng))
    mod = Epilogue(2, None, relu=False)
    v = mod.init({"params": jax.random.PRNGKey(1)}, agg)
    t = jnp.asarray(rng.normal(size=(50, HC)).astype(np.float32))

    def ref(p, agg):
        den = jnp.maximum(agg[:, HC:], 1e-16)
        out = agg[:, :HC] / jnp.repeat(den, HC // H, axis=1) + p["seed"]

        def ln(z, q):
            mu = z.mean(-1, keepdims=True)
            var = ((z - mu) ** 2).mean(-1, keepdims=True)
            return (z - mu) / jnp.sqrt(var + LN_EPS) * q["scale"] + q["bias"]

        z = ln(out, p["ln0"])
        r = p["rFF"]
        h = jnp.maximum(z @ r["lin0"]["kernel"] + r["lin0"]["bias"], 0)
        h = h @ r["lin1"]["kernel"] + r["lin1"]["bias"]
        return ln(z + jnp.maximum(h, 0), p["ln1"])

    with jax.default_matmul_precision("highest"):
        g = jax.grad(lambda p, a: jnp.sum(mod.apply({"params": p}, a) * t),
                     argnums=(0, 1))(v["params"], agg)
        r = jax.grad(lambda p, a: jnp.sum(ref(p, a) * t),
                     argnums=(0, 1))(v["params"], agg)
    for a, b in zip(jax.tree_util.tree_leaves(g), jax.tree_util.tree_leaves(r)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-4, atol=1e-5)
    # the rFF branch carries gradient (relu(h) is not all zero)
    assert float(jnp.abs(g[0]["rFF"]["lin1"]["kernel"]).max()) > 0
