"""Legacy dense-G HGNN (Feng et al. 2019).

Reference ``src/layers.py:202-230`` (HGNN_conv) + ``src/models.py:186-204``
(HGNN). Uses the precomputed dense propagation matrix
G = D_v^{-1/2} H W D_e^{-1} H^T D_v^{-1/2}
(``allset_tpu.graph.transforms.generate_g_from_h``, reference
``src/preprocessing.py:224-259``), carried in ``batch.extras['G']``.
Retained for completeness: the factory routes --method HGNN to HCHA with
symdegnorm instead (``src/train.py:77-82``), as does ours.
"""

from __future__ import annotations

import dataclasses

import jax
from allset_tpu.nn import core

from allset_tpu.graph.batch import Batch
from allset_tpu.nn.modules import TorchDense

Array = jax.Array


@dataclasses.dataclass(frozen=True)
class LegacyHGNNConfig:
    num_features: int
    num_classes: int
    mlp_hidden: int = 64
    dropout: float = 0.5


class LegacyHGNN(core.Module):
    cfg: LegacyHGNNConfig

    @core.compact
    def __call__(self, batch: Batch, train: bool = False) -> Array:
        G = batch.extras["G"]
        x = batch.x
        x = G @ TorchDense(self.cfg.mlp_hidden, name="hgc1")(x)
        x = jax.nn.relu(x)
        # reference calls F.dropout without training= -> always active
        # (src/models.py:202); we keep the standard train-gated behavior.
        x = core.Dropout(self.cfg.dropout)(x, deterministic=not train)
        x = G @ TorchDense(self.cfg.num_classes, name="hgc2")(x)
        return x


@dataclasses.dataclass(frozen=True)
class MLPConfig:
    num_features: int
    num_classes: int
    all_num_layers: int = 2
    mlp_hidden: int = 64
    dropout: float = 0.5
    normalization: str = "ln"
    dtype: str = "float32"  # 'bfloat16' -> mixed precision


class MLPModel(core.Module):
    """Structure-free MLP baseline (``src/models.py:487-577``)."""

    cfg: MLPConfig

    @core.compact
    def __call__(self, batch: Batch, train: bool = False) -> Array:
        import jax.numpy as jnp

        from allset_tpu.nn.modules import MLP

        c = self.cfg
        dt = jnp.bfloat16 if c.dtype == "bfloat16" else None
        x = batch.x if dt is None else batch.x.astype(dt)
        return MLP(
            hidden_channels=c.mlp_hidden,
            out_channels=c.num_classes,
            num_layers=c.all_num_layers,
            dropout=c.dropout,
            normalization=c.normalization,
            input_norm=False,
            dtype=dt,
            name="mlp",
        )(x, train).astype(jnp.float32)
