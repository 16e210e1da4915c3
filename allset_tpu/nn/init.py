"""Parameter initializers reproducing the reference's init semantics.

The reference mixes three init schemes (parity-relevant, SURVEY.md §7.3):
  * torch ``nn.Linear`` default: weight AND bias ~ U(±1/sqrt(fan_in))
    (kaiming_uniform(a=sqrt(5)) reduces to exactly that bound).
  * ``glorot`` (reference ``src/layers.py:31-34``): U(±sqrt(6/(fan_in+fan_out)))
    over the last two dims — applied to PMA's lin_K/lin_V weights.
  * ``nn.init.xavier_uniform_`` on the PMA seed ``att_r`` of shape
    (1, heads, C) (``src/layers.py:104``): torch computes
    fan_in = H*C, fan_out = C for that shape.

Dense kernels here are (in, out) — fan bookkeeping transposed vs torch's
(out, in), but every bound here is symmetric in (fan_in, fan_out) except
the torch-default one, which we close over explicitly.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def torch_linear_kernel():
    """U(±1/sqrt(fan_in)) on an (in, out) kernel."""

    def init(key, shape, dtype=jnp.float32):
        fan_in = shape[0]
        bound = 1.0 / np.sqrt(fan_in) if fan_in > 0 else 0.0
        return jax.random.uniform(key, shape, dtype, -bound, bound)

    return init


def torch_linear_bias(fan_in: int):
    """torch Linear bias: U(±1/sqrt(fan_in)) — fan_in of the layer, which
    a bias initializer can't see, so close over it."""

    def init(key, shape, dtype=jnp.float32):
        bound = 1.0 / np.sqrt(fan_in) if fan_in > 0 else 0.0
        return jax.random.uniform(key, shape, dtype, -bound, bound)

    return init


def glorot_uniform():
    """U(±sqrt(6/(fan_in+fan_out))): reference glorot / xavier_uniform on a
    2-D kernel."""
    return jax.nn.initializers.xavier_uniform()


def xavier_uniform_torch_fans(shape):
    """xavier_uniform_ with torch's fan rule for arbitrary-rank tensors:
    fan_in = shape[1] * prod(shape[2:]), fan_out = shape[0] * prod(shape[2:])."""
    receptive = int(np.prod(shape[2:])) if len(shape) > 2 else 1
    fan_in = shape[1] * receptive
    fan_out = shape[0] * receptive
    bound = float(np.sqrt(6.0 / (fan_in + fan_out)))

    def init(key, shape_, dtype=jnp.float32):
        return jax.random.uniform(key, shape_, dtype, -bound, bound)

    return init


def uniform_symmetric(bound: float):
    """U(±bound): the HyperGCN layer init (reference ``src/utils.py:27-30``)."""

    def init(key, shape, dtype=jnp.float32):
        return jax.random.uniform(key, shape, dtype, -bound, bound)

    return init
