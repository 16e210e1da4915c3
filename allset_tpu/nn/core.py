"""A small module layer: compact-style modules over explicit variable trees.

The models need a narrow slice of what a neural-network library offers:
dataclass modules whose parameters are declared inside ``__call__``, the
``params`` and ``batch_stats`` collections, a named dropout rng stream,
and three layers (LayerNorm, BatchNorm, PReLU). This module provides
exactly that, with plain nested dicts as variable trees, so the program
needs nothing beyond JAX.

    class Dense(Module):
        features: int

        @compact
        def __call__(self, x):
            w = self.param("kernel", jax.nn.initializers.lecun_normal(),
                           (x.shape[-1], self.features))
            return x @ w

    variables = Dense(4).init(key, x)            # {"params": {...}}
    y = Dense(4).apply(variables, x)

Naming and rng derivation follow the layout the checkpoints and the
seeded accuracy records were made with: a child is named explicitly or
``<ClassName>_<k>`` in construction order within its parent; a scope's
``k``-th draw from stream ``s`` folds the SHA-1 of its path and counter
into the root key of ``s``. The same seed therefore gives the same
initial parameters and dropout masks as those records.
"""

from __future__ import annotations

import copy
import dataclasses
import functools
import hashlib
import threading
from typing import Any, Callable, Dict, Optional, Sequence, Tuple, Union

import jax
import jax.numpy as jnp

Array = jax.Array

_STACK = threading.local()


def _scope_stack() -> list:
    if not hasattr(_STACK, "frames"):
        _STACK.frames = []
    return _STACK.frames


def _fold_in_path(key: Array, data: Tuple[Union[str, int], ...]) -> Array:
    """Fold static path data (names and counters) into ``key``."""
    m = hashlib.sha1()
    for x in data:
        if isinstance(x, str):
            m.update(x.encode("utf-8"))
        else:
            m.update(x.to_bytes((x.bit_length() + 7) // 8, byteorder="big"))
    h = int.from_bytes(m.digest()[:4], byteorder="big")
    return jax.random.fold_in(key, jnp.uint32(h))


class _State:
    """Per-``init``/``apply`` state shared by every scope of one call."""

    def __init__(self, variables: Dict[str, dict], rngs: Dict[str, Array],
                 mutable: Sequence[str], initializing: bool):
        self.variables = variables
        self.rngs = rngs
        self.mutable = set(mutable)
        self.initializing = initializing


class Scope:
    """A cursor into the variable trees at one module path."""

    def __init__(self, state: _State, path: Tuple[str, ...]):
        self.state = state
        self.path = path
        self.counters: Dict[str, int] = {}
        self.children: Dict[str, "Scope"] = {}
        self.autonames: Dict[str, int] = {}

    def child(self, name: str) -> "Scope":
        if name not in self.children:
            self.children[name] = Scope(self.state, self.path + (name,))
        return self.children[name]

    def autoname(self, prefix: str) -> str:
        k = self.autonames.get(prefix, 0)
        self.autonames[prefix] = k + 1
        return f"{prefix}_{k}"

    def _node(self, col: str, create: bool) -> Optional[dict]:
        node = self.state.variables.get(col)
        if node is None:
            if not create:
                return None
            node = self.state.variables[col] = {}
        for p in self.path:
            nxt = node.get(p)
            if nxt is None:
                if not create:
                    return None
                nxt = node[p] = {}
            node = nxt
        return node

    def get(self, col: str, name: str) -> Any:
        node = self._node(col, create=False)
        return None if node is None else node.get(name)

    def put(self, col: str, name: str, value: Any) -> None:
        if col not in self.state.mutable:
            raise ValueError(
                f"collection {col!r} is immutable here: pass mutable=[{col!r}] "
                f"to apply() to update {'/'.join(self.path + (name,))}"
            )
        self._node(col, create=True)[name] = value

    def make_rng(self, stream: str) -> Array:
        rngs = self.state.rngs
        if stream not in rngs:
            if "params" not in rngs:
                raise ValueError(
                    f"{'/'.join(self.path) or 'root'} needs an rng for "
                    f"{stream!r}: pass rngs={{{stream!r}: key}}"
                )
            stream = "params"
        self.counters[stream] = self.counters.get(stream, 0) + 1
        return _fold_in_path(rngs[stream], self.path + (self.counters[stream],))


@dataclasses.dataclass(eq=False)
class Module:
    """Base class: subclasses are dataclasses whose fields are the module's
    hyperparameters; ``name`` is keyword-only and optional."""

    name: Optional[str] = dataclasses.field(default=None, kw_only=True)

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        dataclasses.dataclass(cls, eq=False)

    def __post_init__(self):
        frames = _scope_stack()
        scope = None
        if frames:  # constructed inside a parent's compact method: bind
            parent = frames[-1]
            name = self.name or parent.autoname(type(self).__name__)
            object.__setattr__(self, "name", name)
            scope = parent.child(name)
        object.__setattr__(self, "_scope", scope)

    # --- variables and rngs (valid inside a compact method) ---

    def param(self, name: str, init_fn: Callable, *init_args) -> Array:
        scope = self._scope
        value = scope.get("params", name)
        if value is None:
            if not scope.state.initializing:
                raise KeyError(
                    f"parameter {'/'.join(scope.path + (name,))} missing "
                    f"from the variables passed to apply()"
                )
            value = init_fn(scope.make_rng("params"), *init_args)
            scope.put("params", name, value)
        return value

    def make_rng(self, stream: str) -> Array:
        return self._scope.make_rng(stream)

    def is_initializing(self) -> bool:
        return self._scope.state.initializing

    # --- entry points ---

    def _bound(self, state: _State) -> "Module":
        bound = copy.copy(self)
        object.__setattr__(bound, "_scope", Scope(state, ()))
        return bound

    def init(self, rngs: Union[Array, Dict[str, Array]], *args, **kwargs
             ) -> Dict[str, dict]:
        """Run ``__call__`` creating every variable; returns the trees."""
        if not isinstance(rngs, dict):
            rngs = {"params": rngs}
        state = _State({}, rngs, ("params", "batch_stats"), initializing=True)
        self._bound(state)(*args, **kwargs)
        return state.variables

    def apply(self, variables: Dict[str, dict], *args,
              rngs: Optional[Dict[str, Array]] = None,
              mutable: Union[bool, Sequence[str]] = False, **kwargs):
        """Run ``__call__`` with the given variables. With ``mutable`` (a
        list of collections), returns ``(out, {col: updated tree})``."""
        cols = list(variables) if mutable is True else list(mutable or ())
        vs = {
            col: (_copy_tree(tree) if col in cols else tree)
            for col, tree in variables.items()
        }
        state = _State(vs, dict(rngs or {}), cols, initializing=False)
        out = self._bound(state)(*args, **kwargs)
        if not mutable:
            return out
        return out, {col: state.variables.get(col, {}) for col in cols}


def _copy_tree(tree: dict) -> dict:
    return {k: _copy_tree(v) if isinstance(v, dict) else v
            for k, v in tree.items()}


def compact(fn: Callable) -> Callable:
    """Decorate a module's ``__call__``: parameters and child modules may
    be declared inline, and are reused on every later call."""

    @functools.wraps(fn)
    def wrapped(self, *args, **kwargs):
        scope = self._scope
        if scope is None:
            raise RuntimeError(
                f"{type(self).__name__} is unbound: call it through init() "
                f"or apply(), or from inside a parent module"
            )
        frames = _scope_stack()
        frames.append(scope)
        try:
            with jax.named_scope(scope.path[-1] if scope.path else
                                 type(self).__name__):
                return fn(self, *args, **kwargs)
        finally:
            frames.pop()

    return wrapped


# --- layers -----------------------------------------------------------------


def _stats(x: Array, axes: Tuple[int, ...]) -> Tuple[Array, Array]:
    """Mean and variance in (at least) float32, one-pass form clipped at 0."""
    xf = x.astype(jnp.promote_types(x.dtype, jnp.float32))
    mu = xf.mean(axes)
    mu2 = jax.lax.square(xf).mean(axes)
    return mu, jnp.maximum(0.0, mu2 - jax.lax.square(mu))


def _normalize(x, mean, var, scale, bias, eps, dtype, axes):
    mean = jnp.expand_dims(mean, axes)
    var = jnp.expand_dims(var, axes)
    y = x - mean
    mul = jax.lax.rsqrt(var + eps) * scale
    y = y * mul + bias
    out = dtype if dtype is not None else jnp.result_type(x, scale, bias)
    return y.astype(out)


class LayerNorm(Module):
    """Normalize over the last axis; statistics in float32; learned
    ``scale`` (ones) and ``bias`` (zeros). ``dtype`` sets the output."""

    epsilon: float = 1e-6
    dtype: Optional[Any] = None

    @compact
    def __call__(self, x: Array) -> Array:
        feat = (x.shape[-1],)
        scale = self.param("scale", jax.nn.initializers.ones, feat)
        bias = self.param("bias", jax.nn.initializers.zeros, feat)
        mean, var = _stats(x, (x.ndim - 1,))
        return _normalize(x, mean, var, scale, bias, self.epsilon, self.dtype,
                          (x.ndim - 1,))


class BatchNorm(Module):
    """Normalize over every axis but the last with batch statistics
    (training) or the running averages in ``batch_stats`` (evaluation).
    Running averages update as ``m * avg + (1 - m) * batch`` whenever
    statistics are computed outside ``init``."""

    use_running_average: bool = False
    momentum: float = 0.99
    epsilon: float = 1e-5
    dtype: Optional[Any] = None

    @compact
    def __call__(self, x: Array) -> Array:
        scope = self._scope
        feat = (x.shape[-1],)
        axes = tuple(range(x.ndim - 1))
        ra_mean = scope.get("batch_stats", "mean")
        ra_var = scope.get("batch_stats", "var")
        if ra_mean is None:
            ra_mean = jnp.zeros(feat, jnp.float32)
            ra_var = jnp.ones(feat, jnp.float32)
            scope.put("batch_stats", "mean", ra_mean)
            scope.put("batch_stats", "var", ra_var)
        if self.use_running_average:
            mean, var = ra_mean, ra_var
        else:
            mean, var = _stats(x, axes)
            if not self.is_initializing():
                m = self.momentum
                scope.put("batch_stats", "mean", m * ra_mean + (1 - m) * mean)
                scope.put("batch_stats", "var", m * ra_var + (1 - m) * var)
        scale = self.param("scale", jax.nn.initializers.ones, feat)
        bias = self.param("bias", jax.nn.initializers.zeros, feat)
        return _normalize(x, mean, var, scale, bias, self.epsilon, self.dtype,
                          axes)


class Dropout(Module):
    """Zero each element with probability ``rate`` and rescale the rest,
    drawing the mask from the ``dropout`` rng stream."""

    rate: float

    @compact
    def __call__(self, x: Array, deterministic: bool) -> Array:
        if self.rate == 0.0 or deterministic:
            return x
        if self.rate == 1.0:
            return jnp.zeros_like(x)
        keep = 1.0 - self.rate
        mask = jax.random.bernoulli(self.make_rng("dropout"), p=keep,
                                    shape=x.shape)
        return jax.lax.select(mask, x / keep, jnp.zeros_like(x))


class PReLU(Module):
    """leaky_relu with one learned negative slope."""

    negative_slope_init: float = 0.01

    @compact
    def __call__(self, x: Array) -> Array:
        slope = self.param(
            "negative_slope",
            lambda key: jnp.asarray(self.negative_slope_init, jnp.float32),
        )
        return jnp.where(x >= 0, x, jnp.asarray(slope, x.dtype) * x)
