"""Full-batch trainer: whole runs compiled as single XLA programs.

The reference training loop (``src/train.py:458-499``) is a host-side
python loop — per epoch: full-batch forward, NLL loss on the train split,
backward, Adam step, then a second full forward for evaluation
(``src/train.py:474-487``), repeated sequentially for each of ``runs``
random splits.

Redesign for one compiled program:
  * one **epoch** = one fused XLA step (train fwd+bwd+Adam update + eval
    fwd) — no host round trips;
  * one **run** (default 500 epochs) = one ``lax.scan`` over epochs;
  * all **runs** = one ``vmap`` over per-run parameter inits and split
    masks — the 20 statistical replicas of the reference execute in
    parallel on-chip instead of sequentially on host.

Optimizer matches torch.optim.Adam semantics: weight decay is L2 added to
the gradient *before* the Adam moments (``optax.add_decayed_weights``
upstream of ``scale_by_adam``), unlike decoupled AdamW.

Model selection matches the reference Logger (``src/train.py:118-150``):
per run, pick the epoch with max validation accuracy; report the test
accuracy of that epoch; aggregate mean ± std (ddof=1) over runs.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
import optax

from allset_tpu.graph.batch import Batch, split_masks
from allset_tpu.graph.transforms import rand_train_test_idx

Array = jax.Array


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    epochs: int = 500
    runs: int = 20
    lr: float = 1e-3
    wd: float = 0.0
    train_prop: float = 0.5
    valid_prop: float = 0.25
    vmap_runs: bool = True  # parallelize statistical runs on-device
    # vmapped runs per device pass: None = sized from the device's memory
    # limit, halved automatically on RESOURCE_EXHAUSTED (walmart-scale
    # graphs may not fit 20 replicas of the activations)
    vmap_chunk: Optional[int] = None
    # epochs per device call: None = the whole run in one call; a value
    # scans the run in segments of that many epochs (same math)
    epoch_chunk: Optional[int] = None
    eval_every: int = 1  # reference evaluates every epoch (train.py:486)
    # per-epoch progress printing gated like the reference
    # (src/train.py:489-496): print every display_step epochs when > 0.
    # Runs execute on-device (scan/vmap), so lines print from the metrics
    # grid once each run's results land on host — same text, not live.
    display_step: int = -1
    seed: int = 0
    # rematerialize the forward in the backward pass (jax.checkpoint):
    # trades ~1 extra forward of FLOPs for O(activations) memory — lets
    # much larger graphs (or more vmapped runs) fit per chip
    remat: bool = False


def torch_adam(lr: float, wd: float) -> optax.GradientTransformation:
    """torch.optim.Adam(lr, weight_decay=wd): L2 into grads, then Adam.

    optax.flatten runs the whole update on ONE concatenated vector: the
    per-tensor form emits hundreds of parameter-sized XLA ops per step
    (~10-20 us fixed cost each), measurably slow inside a scanned epoch."""
    parts = []
    if wd:
        parts.append(optax.add_decayed_weights(wd))
    parts += [optax.scale_by_adam(b1=0.9, b2=0.999, eps=1e-8), optax.scale(-lr)]
    return optax.flatten(optax.chain(*parts))


def _device_memory_limit() -> Optional[int]:
    """Bytes the default device lets this process allocate, or None when
    the backend does not say (the CPU backend reports no stats)."""
    stats = jax.devices()[0].memory_stats() or {}
    return stats.get("bytes_limit")


def _is_oom(e: Exception) -> bool:
    s = str(e)
    return ("RESOURCE_EXHAUSTED" in s or "Out of memory" in s
            or "Allocation type: HLO temp" in s)


def masked_nll(logits: Array, y: Array, mask: Array) -> Array:
    """mean NLL(log_softmax(logits)) over mask — criterion of train.py:450,480.

    The label pick is a one-hot multiply (iota compare), NOT
    take_along_axis: the compare+reduce fuses into the log_softmax pass
    instead of staging a [N, 1] row gather."""
    logp = jax.nn.log_softmax(logits, axis=-1)
    onehot = (
        jax.lax.broadcasted_iota(jnp.int32, logp.shape, 1) == y[:, None]
    )
    nll = -jnp.sum(jnp.where(onehot, logp, 0.0), axis=-1)
    m = mask.astype(logp.dtype)
    return (nll * m).sum() / jnp.maximum(m.sum(), 1.0)


def masked_acc(logits: Array, y: Array, mask: Array) -> Array:
    pred = jnp.argmax(logits, axis=-1)
    m = mask.astype(jnp.float32)
    return ((pred == y).astype(jnp.float32) * m).sum() / jnp.maximum(m.sum(), 1.0)


class Trainer:
    """Compile-once runner for one (model, batch) pair.

    ``model`` is an ``nn.core`` Module taking ``(batch, train)``; BatchNorm
    models carry a ``batch_stats`` collection transparently.
    """

    def __init__(self, model, batch: Batch, cfg: TrainConfig,
                 tx: Optional[optax.GradientTransformation] = None):
        # vmapped statistical runs compose with the ShardedExchange:
        # jax.vmap pushes the runs axis inside the shard_map bodies,
        # where the per-primitive runs-folding rules (ops/fold.py) fold
        # it into the reduce width per shard — validated against
        # sequential sharded fits in tests/test_parallel.py
        # (test_sharded_vmapped_runs_match_sequential).
        self.model = model
        self.batch = batch
        self.cfg = cfg
        self.tx = tx if tx is not None else torch_adam(cfg.lr, cfg.wd)

    # --- pure functions (jit/vmap targets) ---

    def _init(self, rng: Array, batch):
        variables = self.model.init({"params": rng}, batch, False)
        params = variables["params"]
        batch_stats = variables.get("batch_stats", {})
        return params, batch_stats, self.tx.init(params)

    def _apply(self, batch, params, batch_stats, train: bool, rng: Optional[Array]):
        variables = {"params": params}
        if batch_stats:
            variables["batch_stats"] = batch_stats
        rngs = {"dropout": rng} if rng is not None else None
        if train and batch_stats:
            out, updated = self.model.apply(
                variables, batch, True, rngs=rngs, mutable=["batch_stats"]
            )
            return out, updated["batch_stats"]
        out = self.model.apply(variables, batch, train, rngs=rngs)
        return out, batch_stats

    def _epoch(self, batch, carry, rng, masks):
        """One training update (full-batch fwd+bwd+Adam). Returns train loss."""
        params, batch_stats, opt_state = carry

        def loss_fn(p):
            logits, new_stats = self._apply(batch, p, batch_stats, True, rng)
            return masked_nll(logits, batch.y, masks["train"]), new_stats

        if self.cfg.remat:
            loss_fn = jax.checkpoint(loss_fn)
        (loss, new_stats), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        updates, opt_state = self.tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return (params, new_stats, opt_state), loss

    def _eval(self, batch, params, batch_stats, masks, train_loss):
        """Full evaluation forward (reference evaluate(), train.py:170-193)."""
        y = batch.y
        logits, _ = self._apply(batch, params, batch_stats, False, None)
        return jnp.stack(
            [
                masked_acc(logits, y, masks["train"]),
                masked_acc(logits, y, masks["valid"]),
                masked_acc(logits, y, masks["test"]),
                train_loss,
                masked_nll(logits, y, masks["valid"]),
                masked_nll(logits, y, masks["test"]),
            ]
        )

    def _run_init(self, rng: Array, batch):
        """Per-run setup: parameter init + the dropout key stream root."""
        init_rng, drop_rng = jax.random.split(rng)
        carry = self._init(init_rng, batch)
        return carry, drop_rng

    def _run_segment(self, carry, prev_m, seg_rngs, seg_ids, masks, batch):
        """Scan a SEGMENT of epochs (``epoch_chunk`` splits a run into
        several device calls; one segment spanning all epochs is the
        single-call program). Returns (carry, last_metrics, metrics [E, 6]).

        ``eval_every > 1`` skips the evaluation forward on off epochs
        (lax.cond; skipped rows repeat the last evaluated metrics, so
        best-valid-epoch selection still works on the [epochs, 6] grid);
        the default 1 evaluates every epoch like the reference
        (train.py:486) with no cond overhead."""
        k = max(1, self.cfg.eval_every)
        epochs = self.cfg.epochs

        if k == 1:
            def step(c, inp):
                r, _ = inp
                c, loss = self._epoch(batch, c, r, masks)
                return c, self._eval(batch, c[0], c[1], masks, loss)

            carry, metrics = jax.lax.scan(step, carry, (seg_rngs, seg_ids))
            return carry, metrics[-1], metrics

        def step(c, inp):
            r, ep = inp
            inner, prev = c
            inner, loss = self._epoch(batch, inner, r, masks)
            m = jax.lax.cond(
                jnp.logical_or((ep + 1) % k == 0, ep == epochs - 1),
                lambda: self._eval(batch, inner[0], inner[1], masks, loss),
                lambda: prev,
            )
            return (inner, m), m

        (carry, prev_m), metrics = jax.lax.scan(
            step, (carry, prev_m), (seg_rngs, seg_ids)
        )
        return carry, prev_m, metrics

    def _run(self, rng: Array, masks, batch):
        """One full run as ONE device call: init + scan over all epochs.
        Returns ([epochs, 6], params).

        ``batch`` is threaded as an argument (NOT closed over): closure
        device arrays would bake into the HLO as constants, bloating the
        program and its compile time at large graph sizes."""
        carry, drop_rng = self._run_init(rng, batch)
        epochs = self.cfg.epochs
        epoch_rngs = jax.random.split(drop_rng, epochs)
        carry, _, metrics = self._run_segment(
            carry, jnp.zeros((6,), jnp.float32), epoch_rngs,
            jnp.arange(epochs), masks, batch,
        )
        return metrics, carry[0]

    # --- host orchestration ---

    def _initial_chunk(self) -> int:
        """Vmapped-runs group size from a live-set estimate: ~3 packed
        [nnz, hidden + heads] exchange tables + ~4 [rows, hidden]
        activation tables per run, against half the device's memory limit
        (``memory_stats()["bytes_limit"]``; half, because the estimate
        leaves out the backward's temporaries). A backend that reports no
        limit gets every run at once; the halving loop in ``fit`` is the
        net either way."""
        cfg = self.cfg
        if cfg.vmap_chunk:
            return cfg.vmap_chunk
        inc = getattr(self.batch, "inc", None)
        limit = _device_memory_limit()
        if inc is None or not limit:
            return cfg.runs
        mcfg = getattr(self.model, "cfg", None)
        item = 2 if getattr(mcfg, "dtype", None) == "bfloat16" else 4
        hid = getattr(mcfg, "mlp_hidden", 256) or 256
        W = hid + (getattr(mcfg, "heads", 1) or 1)
        rows = inc.num_nodes + inc.num_edges
        per_run = 3 * inc.nnz * W * item + 4 * rows * hid * item
        return max(1, min(cfg.runs, int(0.5 * limit // max(per_run, 1))))

    def _epoch_chunk(self) -> int:
        return self.cfg.epoch_chunk or self.cfg.epochs

    def _seg_fns(self, vmapped: bool):
        """Jitted (init, rng-split, segment) triple, cached per mode."""
        cache = getattr(self, "_seg_cache", None)
        if cache is None:
            cache = self._seg_cache = {}
        if vmapped not in cache:
            epochs = self.cfg.epochs
            split = lambda r: jax.random.split(r, epochs)
            if vmapped:
                cache[vmapped] = (
                    jax.jit(jax.vmap(self._run_init, in_axes=(0, None))),
                    jax.jit(jax.vmap(split)),
                    jax.jit(jax.vmap(
                        self._run_segment, in_axes=(0, 0, 0, None, 0, None)
                    )),
                )
            else:
                cache[vmapped] = (
                    jax.jit(self._run_init),
                    jax.jit(split),
                    jax.jit(self._run_segment),
                )
        return cache[vmapped]

    def _run_segmented(self, rngs_g, masks_g, echunk: int, vmapped: bool):
        """One run (or vmapped group of runs), scanned in epoch segments
        of ``echunk`` — several device calls instead of one. Identical
        math to the single-call path (same per-epoch rng stream, same
        step function)."""
        epochs = self.cfg.epochs
        init_fn, split_fn, seg_fn = self._seg_fns(vmapped)
        carry, drop = init_fn(rngs_g, self.batch)
        ep_rngs = split_fn(drop)  # [(g,) epochs, key]
        lead = (rngs_g.shape[0],) if vmapped else ()
        prev = jnp.zeros(lead + (6,), jnp.float32)
        ids = jnp.arange(epochs)
        e_ax = 1 if vmapped else 0
        mets = []
        for lo in range(0, epochs, echunk):
            hi = min(lo + echunk, epochs)
            seg = jax.lax.slice_in_dim(ep_rngs, lo, hi, axis=e_ax)
            carry, prev, m = seg_fn(
                carry, prev, seg, ids[lo:hi], masks_g, self.batch
            )
            mets.append(m)
        return jnp.concatenate(mets, axis=e_ax), carry[0]

    def _fit_chunked(self, run_fn, rngs, masks, chunk: int):
        """Run the vmapped protocol in groups of ``chunk`` runs (and, for
        large graphs, epoch segments within each group); group results
        concatenate along the runs axis — identical to one full vmap
        (runs are independent)."""
        runs = self.cfg.runs
        echunk = self._epoch_chunk()
        if chunk >= runs and echunk >= self.cfg.epochs:
            return run_fn(rngs, masks, self.batch)
        mets, ps = [], []
        lo = 0
        while lo < runs:
            hi = min(lo + chunk, runs)
            sl = lambda a: a[lo:hi]
            g_rngs = sl(rngs)
            g_masks = jax.tree_util.tree_map(sl, masks)
            try:
                if echunk >= self.cfg.epochs:
                    m, p = run_fn(g_rngs, g_masks, self.batch)
                else:
                    m, p = self._run_segmented(g_rngs, g_masks, echunk, True)
                # block per group so an OOM raises here (retryable) and
                # the groups don't queue unboundedly
                jax.block_until_ready(m)
            except Exception as e:
                # an OOM in group k must not re-run the k-1 finished
                # groups: halve the group size and retry THIS group only
                if _is_oom(e) and chunk > 1:
                    chunk = (chunk + 1) // 2
                    print(f"[trainer] device memory exhausted; retrying with "
                          f"{chunk} vmapped runs per pass")
                    continue
                raise
            mets.append(m)
            ps.append(p)
            lo = hi
        metrics = jnp.concatenate(mets, axis=0)
        params = jax.tree_util.tree_map(
            lambda *xs: jnp.concatenate(xs, axis=0), *ps
        )
        return metrics, params

    def fit(self, verbose: bool = False) -> "Results":
        cfg = self.cfg
        n = self.batch.num_nodes
        host_rng = np.random.default_rng(cfg.seed)
        y_host = np.asarray(self.batch.y)

        mask_list = []
        for _ in range(cfg.runs):
            idx = rand_train_test_idx(
                y_host, cfg.train_prop, cfg.valid_prop, rng=host_rng
            )
            mask_list.append(split_masks(idx, n))
        masks = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *mask_list)

        rngs = jax.random.split(jax.random.PRNGKey(cfg.seed), cfg.runs)

        t0 = time.time()
        if cfg.vmap_runs:
            # the runs axis FOLDS into the feature axis of every sparse
            # gather/reduce (ops/fold.py batching rules): the vmapped
            # protocol makes one pass per exchange, as a single run does
            run_fn = jax.jit(jax.vmap(self._run, in_axes=(0, 0, None)))
            chunk = self._initial_chunk()
            if chunk < cfg.runs:
                print(f"[trainer] vmapping runs in groups of {chunk} "
                      f"(device-memory estimate)")
            while True:
                try:
                    metrics, params = self._fit_chunked(
                        run_fn, rngs, masks, chunk
                    )
                    break
                except Exception as e:  # jaxlib XlaRuntimeError
                    # single-full-vmap OOM (chunk == runs): drop into
                    # grouped mode; per-group OOMs retry inside
                    # _fit_chunked without re-running finished groups
                    if _is_oom(e) and chunk > 1:
                        chunk = (chunk + 1) // 2
                        print(
                            f"[trainer] device memory exhausted; retrying with "
                            f"{chunk} vmapped runs per pass"
                        )
                    else:
                        raise
            metrics = np.asarray(metrics)  # [runs, epochs, 6]
        else:
            run_fn = jax.jit(self._run)
            echunk = self._epoch_chunk()
            outs = []
            params = None
            for r in range(cfg.runs):
                masks_r = jax.tree_util.tree_map(lambda a: a[r], masks)
                if echunk >= cfg.epochs:
                    m, params = run_fn(rngs[r], masks_r, self.batch)
                else:
                    m, params = self._run_segmented(
                        rngs[r], masks_r, echunk, False
                    )
                outs.append(np.asarray(m))
            metrics = np.stack(outs)
        jax.block_until_ready(jax.tree_util.tree_leaves(params)[0] if params is not None else metrics)
        wall = time.time() - t0
        if cfg.display_step > 0:
            self._print_progress(np.asarray(metrics))

        return Results(
            metrics=metrics, wall_time=wall,
            num_params=count_params(params, cfg.vmap_runs),
            params=params, params_batched=cfg.vmap_runs,
        )


    def _print_progress(self, metrics: np.ndarray) -> None:
        """Reference-format per-epoch lines (``src/train.py:489-496``),
        one block per run, every ``display_step`` epochs (epoch 0 prints,
        matching ``epoch % display_step == 0``)."""
        step = self.cfg.display_step
        for run in range(metrics.shape[0]):
            for epoch in range(0, metrics.shape[1], step):
                m = metrics[run, epoch]
                print(
                    f"Epoch: {epoch:02d}, "
                    f"Train Loss: {m[3]:.4f}, "
                    f"Valid Loss: {m[4]:.4f}, "
                    f"Test  Loss: {m[5]:.4f}, "
                    f"Train Acc: {100 * m[0]:.2f}%, "
                    f"Valid Acc: {100 * m[1]:.2f}%, "
                    f"Test  Acc: {100 * m[2]:.2f}%"
                )


def count_params(params, batched: bool) -> int:
    if params is None:
        return 0
    leaves = jax.tree_util.tree_leaves(params)
    total = sum(int(np.prod(l.shape)) for l in leaves)
    if batched and leaves:
        # vmapped params carry a leading runs axis
        total //= leaves[0].shape[0]
    return total


@dataclasses.dataclass
class Results:
    """Reference-Logger-compatible statistics (``src/train.py:118-150``)."""

    metrics: np.ndarray  # [runs, epochs, 6] = train/val/test acc, 3 losses
    wall_time: float
    num_params: int
    # final-epoch parameters: vmapped runs carry a leading runs axis
    # (params_batched=True); sequential runs keep ONLY the last run's
    # params. The reference main pipeline never saves model state
    # (SURVEY.md §5.4); this is the net-new checkpoint hook
    # (utils/checkpoint.save_checkpoint).
    params: Any = None
    params_batched: bool = False

    def best_by_valid(self) -> Dict[str, Any]:
        acc = self.metrics[:, :, :3] * 100.0
        best_epoch = acc[:, :, 1].argmax(axis=1)
        runs = np.arange(acc.shape[0])
        highest_train = acc[:, :, 0].max(axis=1)
        highest_valid = acc[:, :, 1].max(axis=1)
        final_train = acc[runs, best_epoch, 0]
        final_test = acc[runs, best_epoch, 2]

        def ms(v):
            return float(v.mean()), float(v.std(ddof=1)) if len(v) > 1 else 0.0

        return {
            "highest_train": ms(highest_train),
            "highest_valid": ms(highest_valid),
            "final_train": ms(final_train),
            "final_test": ms(final_test),
            "best_epoch": best_epoch,
        }

    def plot(self, path: Optional[str] = None, run: Optional[int] = None):
        """Accuracy curves, mirroring the reference ``Logger.plot_result``
        (``src/train.py:152-167``): train/valid/test accuracy per epoch,
        averaged over runs (or a single run). Saves to ``path`` when given,
        else returns the matplotlib figure."""
        from allset_tpu.utils import require

        matplotlib = require("matplotlib", "plotting accuracy curves")
        if path is not None:
            matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        acc = self.metrics[:, :, :3] * 100.0
        curves = acc[run] if run is not None else acc.mean(axis=0)
        fig, ax = plt.subplots(figsize=(7, 4))
        for i, label in enumerate(["train", "valid", "test"]):
            ax.plot(curves[:, i], label=label)
        ax.set_xlabel("epoch")
        ax.set_ylabel("accuracy (%)")
        ax.legend()
        fig.tight_layout()
        if path is not None:
            fig.savefig(path, dpi=120)
            plt.close(fig)
            return path
        return fig

    def summary(self) -> str:
        s = self.best_by_valid()
        lines = ["All runs:"]
        for k, label in [
            ("highest_train", "Highest Train"),
            ("highest_valid", "Highest Valid"),
            ("final_train", "  Final Train"),
            ("final_test", "   Final Test"),
        ]:
            m, d = s[k]
            lines.append(f"{label}: {m:.2f} ± {d:.2f}")
        lines.append(f"params: {self.num_params}, wall: {self.wall_time:.2f}s")
        return "\n".join(lines)
