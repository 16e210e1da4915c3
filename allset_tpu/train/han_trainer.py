"""HAN full-batch trainer with early stopping + best-checkpoint restore.

Reference ``src/DGL_HAN/main.py:82-177``: per run — fresh split, HAN over
the metapath graphs, cross-entropy on the train mask, Adam, per-epoch
validation with the dual-criterion EarlyStopping, restore best checkpoint,
report test accuracy / micro-F1 / macro-F1 mean ± std over runs.

Early stopping is inherently data-dependent control flow, so (unlike the
main trainer's scan-over-epochs) the epoch loop runs on host around one
fused jitted step.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict

import jax
import jax.numpy as jnp
import numpy as np
import optax

from allset_tpu.graph.batch import Batch, split_masks
from allset_tpu.graph.transforms import rand_train_test_idx
from allset_tpu.train.trainer import masked_acc, masked_nll, torch_adam
from allset_tpu.utils.checkpoint import EarlyStopping


@dataclasses.dataclass(frozen=True)
class HANTrainConfig:
    num_epochs: int = 200
    runs: int = 10
    lr: float = 0.005
    weight_decay: float = 0.001
    patience: int = 100
    train_prop: float = 0.5
    valid_prop: float = 0.25
    seed: int = 0


def f1_scores(y_true: np.ndarray, y_pred: np.ndarray):
    """(micro, macro) F1 over the classes present in either array — the
    definitions of sklearn's ``f1_score(average=...)``. Micro-F1 of a
    single-label problem equals accuracy; a class with no true and no
    predicted member is absent, and 0/0 counts as 0."""
    y_true = np.asarray(y_true).ravel()
    y_pred = np.asarray(y_pred).ravel()
    classes = np.union1d(y_true, y_pred)
    tp = np.array([np.sum((y_true == c) & (y_pred == c)) for c in classes])
    fp = np.array([np.sum((y_true != c) & (y_pred == c)) for c in classes])
    fn = np.array([np.sum((y_true == c) & (y_pred != c)) for c in classes])
    denom = 2 * tp + fp + fn
    per_class = np.where(denom > 0, 2 * tp / np.maximum(denom, 1), 0.0)
    micro_den = 2 * tp.sum() + fp.sum() + fn.sum()
    micro = 2 * tp.sum() / micro_den if micro_den else 0.0
    return float(micro), float(per_class.mean()) if len(classes) else 0.0


def train_han(model, batch: Batch, num_real_nodes: int, cfg: HANTrainConfig,
              verbose: bool = False) -> Dict[str, float]:
    """batch.y uses -1 for hyperedge rows; splits only cover real nodes."""
    tx = torch_adam(cfg.lr, cfg.weight_decay)
    host_rng = np.random.default_rng(cfg.seed)
    y_host = np.asarray(batch.y)

    # batch threaded as an argument (closure device arrays bake into the
    # HLO as constants — remote-compile size limit at large graphs)
    @jax.jit
    def step(params, opt_state, masks, rng, batch):
        def loss_fn(p):
            logits = model.apply({"params": p}, batch, True, rngs={"dropout": rng})
            return masked_nll(logits, jnp.maximum(batch.y, 0), masks["train"])

        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        logits = model.apply({"params": params}, batch, False)
        y = jnp.maximum(batch.y, 0)
        val_loss = masked_nll(logits, y, masks["valid"])
        val_acc = masked_acc(logits, y, masks["valid"])
        return params, opt_state, loss, val_loss, val_acc

    @jax.jit
    def predict(params, batch):
        return jnp.argmax(model.apply({"params": params}, batch, False), axis=-1)

    accs, micros, macros, times = [], [], [], []
    for run in range(cfg.runs):
        t0 = time.time()
        split = rand_train_test_idx(
            y_host, cfg.train_prop, cfg.valid_prop, rng=host_rng
        )
        masks = split_masks(split, batch.num_nodes)

        rng = jax.random.PRNGKey(cfg.seed + run)
        params = model.init(
            {"params": rng}, batch, False
        )["params"]
        opt_state = tx.init(params)
        stopper = EarlyStopping(patience=cfg.patience)

        for epoch in range(cfg.num_epochs):
            rng, drop = jax.random.split(rng)
            params, opt_state, loss, val_loss, val_acc = step(
                params, opt_state, masks, drop, batch
            )
            if stopper.step(float(val_loss), float(val_acc), params):
                break

        best = stopper.restore()
        pred = np.asarray(predict(best, batch))
        test_idx = np.asarray(split["test"])
        yt = y_host[test_idx]
        yp = pred[test_idx]
        acc = float((yt == yp).mean())
        micro, macro = f1_scores(yt, yp)
        accs.append(100 * acc)
        micros.append(100 * micro)
        macros.append(100 * macro)
        times.append(time.time() - t0)
        if verbose:
            print(f"run {run}: acc={acc:.4f} micro={micro:.4f} macro={macro:.4f}")

    return {
        "test_acc_mean": float(np.mean(accs)),
        "test_acc_std": float(np.std(accs)),
        "micro_f1_mean": float(np.mean(micros)),
        "micro_f1_std": float(np.std(micros)),
        "macro_f1_mean": float(np.mean(macros)),
        "macro_f1_std": float(np.std(macros)),
        "time_per_run": float(np.mean(times)),
    }


@dataclasses.dataclass(frozen=True)
class HANSampleConfig:
    """Sampled-HAN knobs (reference ``train_sampling.py`` defaults:
    batch 32, 20 neighbors, 2x neighbors at eval)."""

    batch_size: int = 32
    num_neighbors: int = 20
    num_epochs: int = 200
    runs: int = 3
    lr: float = 0.005
    weight_decay: float = 0.001
    patience: int = 10
    train_prop: float = 0.5
    valid_prop: float = 0.25
    seed: int = 0


def train_han_minibatch(model, x_full, y, sampler, cfg: HANSampleConfig,
                        verbose: bool = False) -> Dict[str, float]:
    """Mini-batch HAN (reference ``DGL_HAN/train_sampling.py:231-348``):
    per epoch, shuffled static-size seed batches; blocks sampled on host
    (the DataLoader-worker role); one jitted step per batch; eval with
    2x neighbors; dual-criterion early stopping; best-checkpoint restore."""
    from allset_tpu.models.han import SampledHAN  # noqa: F401 (doc pointer)

    tx = torch_adam(cfg.lr, cfg.weight_decay)
    y_host = np.asarray(y)
    host_rng = np.random.default_rng(cfg.seed)

    @jax.jit
    def step(params, opt_state, seeds, blocks, valid, rng, x_full, y):
        def loss_fn(p):
            logits = model.apply(
                {"params": p}, x_full, seeds, blocks, True, rngs={"dropout": rng}
            )
            yb = jnp.take(y, seeds, axis=0, mode="clip")
            logp = jax.nn.log_softmax(logits, axis=-1)
            nll = -jnp.take_along_axis(logp, jnp.maximum(yb, 0)[:, None], 1)[:, 0]
            v = valid.astype(logp.dtype)
            return (nll * v).sum() / jnp.maximum(v.sum(), 1.0)

        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss

    @jax.jit
    def infer(params, seeds, blocks, x_full):
        return jnp.argmax(model.apply({"params": params}, x_full, seeds, blocks, False), -1)

    def blocks_to_arrays(blocks):
        out = {}
        for name, b in blocks.items():
            out[f"{name}_src"] = jnp.asarray(b.src)
            out[f"{name}_mask"] = jnp.asarray(b.mask)
        return out

    def evaluate_ids(params, nids, k):
        preds, labels = [], []
        for seeds, valid in sampler.batches(nids, cfg.batch_size, shuffle=False):
            blocks = blocks_to_arrays(sampler.sample(seeds, num_neighbors=k))
            pred = np.asarray(infer(params, jnp.asarray(seeds), blocks, x_full))
            preds.append(pred[valid])
            labels.append(y_host[seeds[valid]])
        preds = np.concatenate(preds)
        labels = np.concatenate(labels)
        acc = float((preds == labels).mean())
        micro, macro = f1_scores(labels, preds)
        return acc, micro, macro

    accs, micros, macros, times = [], [], [], []
    for run in range(cfg.runs):
        t0 = time.time()
        split = rand_train_test_idx(y_host, cfg.train_prop, cfg.valid_prop, rng=host_rng)
        rng = jax.random.PRNGKey(cfg.seed + run)
        seeds0, valid0 = next(sampler.batches(split["train"], cfg.batch_size))
        blocks0 = blocks_to_arrays(sampler.sample(seeds0))
        params = model.init(
            {"params": rng}, x_full, jnp.asarray(seeds0), blocks0, False
        )["params"]
        opt_state = tx.init(params)
        stopper = EarlyStopping(patience=cfg.patience)

        for epoch in range(cfg.num_epochs):
            for seeds, valid in sampler.batches(split["train"], cfg.batch_size):
                rng, drop = jax.random.split(rng)
                blocks = blocks_to_arrays(sampler.sample(seeds))
                params, opt_state, loss = step(
                    params, opt_state, jnp.asarray(seeds), blocks,
                    jnp.asarray(valid), drop, x_full, y,
                )
            val_acc, _, _ = evaluate_ids(params, split["valid"], 2 * cfg.num_neighbors)
            if stopper.step(-val_acc, val_acc, params):
                break

        best = stopper.restore()
        acc, micro, macro = evaluate_ids(best, split["test"], 2 * cfg.num_neighbors)
        accs.append(100 * acc); micros.append(100 * micro); macros.append(100 * macro)
        times.append(time.time() - t0)
        if verbose:
            print(f"run {run}: acc={acc:.4f} micro={micro:.4f} macro={macro:.4f}")

    return {
        "test_acc_mean": float(np.mean(accs)),
        "test_acc_std": float(np.std(accs)),
        "micro_f1_mean": float(np.mean(micros)),
        "micro_f1_std": float(np.std(micros)),
        "macro_f1_mean": float(np.mean(macros)),
        "macro_f1_std": float(np.std(macros)),
        "time_per_run": float(np.mean(times)),
    }
