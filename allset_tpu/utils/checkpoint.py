"""Checkpointing: save/restore parameter pytrees.

The reference's only checkpointing is the HAN vertical's EarlyStopping
(``src/DGL_HAN/utils.py:369-404``): best state_dict to a timestamped file,
reloaded before the final test. The main pipeline has none (SURVEY.md §5.4).
Here checkpointing is a first-class utility usable by every trainer:
a flat ``np.savez`` archive on disk (one array per leaf, keyed by its
``/``-joined tree path), plus an in-memory best-params tracker.
"""

from __future__ import annotations

import os
import os.path as osp
from typing import Any, Optional

import jax
import numpy as np


def _leaf_key(path) -> str:
    return "/".join(
        str(getattr(k, "key", getattr(k, "idx", getattr(k, "name", k))))
        for k in path
    )


def save_checkpoint(path: str, tree: Any) -> None:
    """Write every leaf of ``tree`` to one uncompressed ``.npz`` at ``path``."""
    os.makedirs(osp.dirname(osp.abspath(path)), exist_ok=True)
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    arrays = {_leaf_key(p): np.asarray(v) for p, v in leaves}
    with open(path, "wb") as f:
        np.savez(f, **arrays)


def load_checkpoint(path: str, target: Any) -> Any:
    """Read a checkpoint into the structure of ``target`` (whose leaves
    only name the paths; their values are ignored)."""
    leaves, treedef = jax.tree_util.tree_flatten_with_path(target)
    with np.load(path, allow_pickle=False) as z:
        missing = [_leaf_key(p) for p, _ in leaves if _leaf_key(p) not in z]
        if missing:
            raise KeyError(f"checkpoint {path} lacks {missing[:5]}")
        return jax.tree_util.tree_unflatten(
            treedef, [z[_leaf_key(p)] for p, _ in leaves]
        )


class EarlyStopping:
    """The reference's dual-criterion early stopper
    (``src/DGL_HAN/utils.py:380-396``): count a strike when val loss rose
    AND val acc fell; snapshot params when loss <= best AND acc >= best."""

    def __init__(self, patience: int = 10, checkpoint_path: Optional[str] = None):
        self.patience = patience
        self.checkpoint_path = checkpoint_path
        self.counter = 0
        self.best_loss: Optional[float] = None
        self.best_acc: Optional[float] = None
        self.best_params: Any = None
        self.early_stop = False

    def step(self, loss: float, acc: float, params: Any) -> bool:
        if self.best_loss is None:
            self.best_loss, self.best_acc = loss, acc
            self._save(params)
        elif loss > self.best_loss and acc < self.best_acc:
            self.counter += 1
            if self.counter >= self.patience:
                self.early_stop = True
        else:
            if loss <= self.best_loss and acc >= self.best_acc:
                self._save(params)
            self.best_loss = min(loss, self.best_loss)
            self.best_acc = max(acc, self.best_acc)
            self.counter = 0
        return self.early_stop

    def _save(self, params: Any) -> None:
        self.best_params = jax.tree_util.tree_map(lambda a: a, params)
        if self.checkpoint_path is not None:
            save_checkpoint(self.checkpoint_path, params)

    def restore(self, target: Any = None) -> Any:
        if self.checkpoint_path is not None and target is not None:
            return load_checkpoint(self.checkpoint_path, target)
        return self.best_params
