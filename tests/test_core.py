"""The in-repo module layer (allset_tpu/nn/core.py) and what rests on it:
variable-tree layout, seeded determinism, the three layers against numpy,
checkpoints, and an import of the program with flax unavailable."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from allset_tpu.nn import core

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tree(variables):
    return {
        col: {
            "/".join(str(k.key) for k in path): tuple(leaf.shape)
            for path, leaf in jax.tree_util.tree_leaves_with_path(t)
        }
        for col, t in variables.items()
    }


def _model(method, norm, hyperdata):
    from allset_tpu.train.factory import ExperimentConfig, prepare

    cfg = ExperimentConfig(method=method, mlp_hidden=16, classifier_hidden=8,
                           heads=2, all_num_layers=1, normalization=norm)
    model, batch, _ = prepare(cfg, hyperdata)
    return model, batch


def test_setgnn_variable_tree(hyperdata):
    """AllSetTransformer's parameter names and shapes: the layout
    checkpoints and the trainer's tree handling rely on."""
    model, batch = _model("AllSetTransformer", "ln", hyperdata)
    tree = _tree(model.init({"params": jax.random.PRNGKey(0)}, batch, False))
    want = {}
    for half in ("V2E_0", "E2V_0"):
        p = f"{half}/prop/"
        want.update({p + "att_r": (1, 2, 8)})
        for lin in ("lin_K", "lin_V", "rFF/lin0", "rFF/lin1"):
            want.update({p + f"{lin}/kernel": (16, 16), p + f"{lin}/bias": (16,)})
        for ln in ("ln0", "ln1"):
            want.update({p + f"{ln}/scale": (16,), p + f"{ln}/bias": (16,)})
    want.update({
        "classifier/lin0/kernel": (16, 8), "classifier/lin0/bias": (8,),
        "classifier/lin1/kernel": (8, 3), "classifier/lin1/bias": (3,),
        "classifier/norm0/LayerNorm_0/scale": (8,),
        "classifier/norm0/LayerNorm_0/bias": (8,),
    })
    assert tree == {"params": want}


def test_batchnorm_model_variable_tree(hyperdata):
    """AllDeepSets with BatchNorm: params plus a batch_stats collection
    whose mean/var mirror every BatchNorm's scale/bias."""
    model, batch = _model("AllDeepSets", "bn", hyperdata)
    tree = _tree(model.init({"params": jax.random.PRNGKey(0)}, batch, False))
    assert set(tree) == {"params", "batch_stats"}
    bn_params = {k.rsplit("/", 1)[0] for k in tree["params"]
                 if "BatchNorm_0" in k}
    bn_stats = {k.rsplit("/", 1)[0] for k in tree["batch_stats"]}
    assert bn_params == bn_stats and len(bn_stats) == 9
    for k, shape in tree["batch_stats"].items():
        assert k.endswith(("/mean", "/var"))
        assert tree["params"][k.rsplit("/", 1)[0] + "/scale"] == shape
    assert tree["params"]["V2E_0/f_enc/lin0/kernel"] == (16, 16)
    assert tree["params"]["classifier/lin1/kernel"] == (8, 3)


def test_seed_determinism(hyperdata):
    """Same seed -> identical params and dropout outputs; another seed
    differs."""
    model, batch = _model("AllSetTransformer", "ln", hyperdata)

    def run(seed):
        v = model.init({"params": jax.random.PRNGKey(seed)}, batch, False)
        out = model.apply(v, batch, True, rngs={"dropout": jax.random.PRNGKey(seed)})
        return v, np.asarray(out)

    (v0, o0), (v1, o1), (v2, o2) = run(0), run(0), run(1)
    for a, b in zip(jax.tree_util.tree_leaves(v0), jax.tree_util.tree_leaves(v1)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    np.testing.assert_array_equal(o0, o1)
    assert not np.allclose(o0, o2)


def test_dropout_train_and_eval():
    x = jnp.ones((200, 50))
    drop = core.Dropout(0.3)
    v = drop.init({"params": jax.random.PRNGKey(0)}, x, deterministic=True)
    assert v == {}
    np.testing.assert_array_equal(
        np.asarray(drop.apply(v, x, deterministic=True)), np.asarray(x))
    y = np.asarray(drop.apply(v, x, deterministic=False,
                              rngs={"dropout": jax.random.PRNGKey(1)}))
    kept = y != 0
    assert 0.6 < kept.mean() < 0.8
    np.testing.assert_allclose(y[kept], 1.0 / 0.7, rtol=1e-6)
    y2 = np.asarray(drop.apply(v, x, deterministic=False,
                               rngs={"dropout": jax.random.PRNGKey(2)}))
    assert (y2 != y).any()


def test_layernorm_and_prelu_match_numpy(rng):
    x = rng.normal(size=(7, 12)).astype(np.float32) * 3 + 1
    ln = core.LayerNorm(epsilon=1e-5)
    v = ln.init({"params": jax.random.PRNGKey(0)}, x)
    scale = rng.normal(size=12).astype(np.float32)
    bias = rng.normal(size=12).astype(np.float32)
    v = {"params": {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}}
    mu = x.mean(-1, keepdims=True)
    var = x.var(-1, keepdims=True)
    want = (x - mu) / np.sqrt(var + 1e-5) * scale + bias
    np.testing.assert_allclose(np.asarray(ln.apply(v, x)), want,
                               rtol=1e-5, atol=1e-5)
    pr = core.PReLU(0.25)
    pv = pr.init({"params": jax.random.PRNGKey(0)}, x)
    np.testing.assert_allclose(np.asarray(pr.apply(pv, x)),
                               np.where(x >= 0, x, 0.25 * x), rtol=1e-6)


def test_batchnorm_matches_numpy(rng):
    """Training mode normalizes with batch statistics and updates the
    running averages (momentum m); evaluation mode uses the averages."""
    x = rng.normal(size=(64, 5)).astype(np.float32) * 2 + 3
    bn = core.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    v = bn.init({"params": jax.random.PRNGKey(0)}, x)
    np.testing.assert_array_equal(np.asarray(v["batch_stats"]["mean"]), 0.0)
    np.testing.assert_array_equal(np.asarray(v["batch_stats"]["var"]), 1.0)
    y, upd = bn.apply(v, x, mutable=["batch_stats"])
    mu, var = x.mean(0), x.var(0)
    np.testing.assert_allclose(np.asarray(y), (x - mu) / np.sqrt(var + 1e-5),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(np.asarray(upd["batch_stats"]["mean"]),
                               0.1 * mu, rtol=1e-5)
    np.testing.assert_allclose(np.asarray(upd["batch_stats"]["var"]),
                               0.9 + 0.1 * var, rtol=1e-5)
    ev = core.BatchNorm(use_running_average=True, epsilon=1e-5)
    v2 = {"params": v["params"], "batch_stats": upd["batch_stats"]}
    rm, rv = 0.1 * mu, 0.9 + 0.1 * var
    np.testing.assert_allclose(np.asarray(ev.apply(v2, x)),
                               (x - rm) / np.sqrt(rv + 1e-5),
                               rtol=1e-4, atol=1e-4)
    with pytest.raises(ValueError, match="immutable"):
        bn.apply(v, x)  # batch statistics would need mutable=


def test_checkpoint_round_trip(tmp_path, hyperdata):
    from allset_tpu.utils.checkpoint import load_checkpoint, save_checkpoint

    model, batch = _model("AllSetTransformer", "ln", hyperdata)
    v = model.init({"params": jax.random.PRNGKey(3)}, batch, False)
    path = str(tmp_path / "ck" / "params.npz")
    save_checkpoint(path, v)
    target = jax.tree_util.tree_map(jnp.zeros_like, v)
    back = load_checkpoint(path, target)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(v)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(v)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    np.testing.assert_array_equal(
        np.asarray(model.apply(back, batch, False)),
        np.asarray(model.apply(v, batch, False)))


def test_program_imports_without_flax():
    """The cli, models, train, parallel and checkpoint modules import, and
    a tiny cli run trains, with flax, msgpack and the other optional
    packages unimportable."""
    code = r"""
import sys
BLOCK = ("flax", "msgpack", "yaml", "rich", "pandas", "sklearn", "matplotlib")
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCK:
            raise ImportError("blocked " + name)
sys.meta_path.insert(0, Block())
import allset_tpu.cli, allset_tpu.models, allset_tpu.train
import allset_tpu.parallel.sharded, allset_tpu.utils.checkpoint
import allset_tpu.train.han_trainer
assert not any(m.split(".")[0] in BLOCK for m in sys.modules)
allset_tpu.cli.main(["--dname", "synthetic", "--method", "AllSetTransformer",
                     "--epochs", "2", "--runs", "2", "--MLP_hidden", "16",
                     "--Classifier_hidden", "16", "--res_root", sys.argv[1]])
print("NOFLAX_OK")
"""
    import tempfile

    with tempfile.TemporaryDirectory() as res:
        env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
        r = subprocess.run([sys.executable, "-c", code, res], env=env,
                           capture_output=True, text=True, timeout=600,
                           cwd=REPO)
    assert r.returncode == 0 and "NOFLAX_OK" in r.stdout, r.stderr[-3000:]
