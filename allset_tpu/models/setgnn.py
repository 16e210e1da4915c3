"""SetGNN: the AllSet model (AllSetTransformer / AllDeepSets).

Reference ``src/models.py:295-484``. ``All_num_layers`` rounds of two-stage
multiset aggregation — V->E then E->V over the bipartite incidence — each
stage a learnable multiset function (HalfNLHconv), then an MLP classifier.

Config rules (mirroring the reference factory ``src/train.py:30-42``):
  * pma=True                       -> AllSetTransformer
  * pma=False and aggregate='add'  -> AllDeepSets
  * gpr: stack per-layer outputs, learn scalar mixing weights
    (``src/models.py:389-397,457-471``)
  * learn_mask: learnable per-incidence-entry importance multiplied into
    norm (``src/models.py:336-337,451-452``)
  * fixed input dropout p=0.2 in the non-GPR path (``src/models.py:473``)
  * BatchNorms bnV2Es/bnE2Vs exist in the reference but are commented out
    of its forward (``src/models.py:462,476``) — not re-created here.

Both directions run over the same canonically-ordered entry list (V2E
segment-sorted); E2V reuses it with roles swapped, so LearnMask importance
stays entry-consistent.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
from allset_tpu.nn import core

from allset_tpu.graph.batch import Batch
from allset_tpu.nn.modules import MLP, HalfNLHconv, TorchDense

Array = jax.Array


@dataclasses.dataclass(frozen=True)
class SetGNNConfig:
    """Hyperparameters of SetGNN; field names follow the reference CLI
    flags (``src/train.py:221-287``) with pythonic casing."""

    num_features: int
    num_classes: int
    all_num_layers: int = 2
    mlp_num_layers: int = 2
    mlp_hidden: int = 64
    classifier_num_layers: int = 2
    classifier_hidden: int = 64
    heads: int = 1
    dropout: float = 0.5
    aggregate: str = "mean"  # 'add' | 'mean' ('sum' == 'add')
    normalization: str = "ln"
    deepset_input_norm: bool = True
    pma: bool = True
    gpr: bool = False
    learn_mask: bool = False
    # 'float32' (default, parity) or 'bfloat16' (mixed precision: bf16
    # activations/GEMMs/sparse traffic, f32 params + softmax + layer stats)
    dtype: str = "float32"

    @classmethod
    def all_deep_sets(cls, **kw) -> "SetGNNConfig":
        """The AllDeepSets factory override (``src/train.py:37-38``)."""
        kw.update(pma=False, aggregate="add")
        return cls(**kw)


class SetGNN(core.Module):
    cfg: SetGNNConfig

    @property
    def _dtype(self):
        import jax.numpy as jnp

        return jnp.bfloat16 if self.cfg.dtype == "bfloat16" else None

    def _half_conv(self, in_is_first: bool, name: str) -> HalfNLHconv:
        c = self.cfg
        return HalfNLHconv(
            hid_dim=c.mlp_hidden,
            out_dim=c.mlp_hidden,
            num_layers=c.mlp_num_layers,
            dropout=c.dropout,
            normalization=c.normalization,
            input_norm=c.deepset_input_norm,
            heads=c.heads,
            attention=c.pma,
            dtype=self._dtype,
            norm_grad=c.learn_mask,
            # the inter-stage relu (src/models.py:475-479) folds into the
            # half-layer; the DeepSets path's own final relu makes it
            # idempotent
            fold_relu=True,
            name=name,
        )

    @core.compact
    def __call__(self, batch: Batch, train: bool = False) -> Array:
        c = self.cfg
        x, inc = batch.x, batch.inc
        norm = inc.norm
        if c.learn_mask:
            importance = self.param(
                "importance", jax.nn.initializers.ones, (inc.nnz_padded,)
            )
            norm = importance * norm

        if c.all_num_layers == 0:
            return MLP(
                hidden_channels=c.classifier_hidden,
                out_channels=c.num_classes,
                num_layers=c.classifier_num_layers,
                dropout=c.dropout,
                normalization=c.normalization,
                input_norm=False,
                dtype=self._dtype,
                name="classifier",
            )(x, train).astype(jnp.float32)

        classifier = MLP(
            hidden_channels=c.classifier_hidden,
            out_channels=c.num_classes,
            num_layers=c.classifier_num_layers,
            dropout=c.dropout,
            normalization=c.normalization,
            input_norm=False,
            dtype=self._dtype,
            name="classifier",
        )

        # Two directed views over the same entry list: V2E in canonical
        # (edge-sorted) order, E2V in the node-sorted second order — every
        # segment reduce (fwd and gather-bwd) runs sorted (ops/exchange).
        if (
            batch.shex is not None
            # LearnMask's traced canonical norm needs an UNSPLIT exchange
            # (ShardedExchange.build(split=False)) so self-loop entries
            # are covered by the canonical entry indexing
            and (not c.learn_mask or batch.shex.v2e.sl_mode == "none")
            and c.normalization != "bn"  # N-slot hole rows vs batch stats
        ):
            # explicit shard_map edge-partitioned exchange (multi-chip)
            d_v2e, d_e2v = batch.shex.v2e, batch.shex.e2v
            if c.learn_mask:
                d_v2e = dataclasses.replace(d_v2e, norm_canon=norm)
                d_e2v = dataclasses.replace(d_e2v, norm_canon=norm)
        elif inc.node_perm is not None and jax.device_count() == 1:
            if inc.real is not None and not c.learn_mask and c.normalization != "bn":
                # self-loop suffix split: sparse core over real edges only;
                # singleton self-loop edges become identity row slices in
                # an N-slot edge-state layout (holes masked). Gated off for
                # 'bn' (hole junk rows would pollute batch statistics).
                d_v2e, d_e2v = inc.v2e_split(), inc.e2v_split()
            else:
                d_v2e, d_e2v = inc.v2e(norm), inc.e2v(norm)
        else:
            from allset_tpu.graph.incidence import Direction

            d_v2e = Direction.plain(
                inc.node, inc.edge, norm, inc.mask,
                num_src=inc.num_nodes, num_dst=inc.num_edges, dst_is_sorted=True,
            )
            d_e2v = Direction.plain(
                inc.edge, inc.node, norm, inc.mask,
                num_src=inc.num_edges, num_dst=inc.num_nodes, dst_is_sorted=False,
            )

        def v2e(i, h):
            return self._half_conv(i == 0, f"V2E_{i}")(
                h, d_v2e, aggr=c.aggregate, train=train
            )

        def e2v(i, h):
            return self._half_conv(False, f"E2V_{i}")(
                h, d_e2v, aggr=c.aggregate, train=train
            )

        drop = core.Dropout(c.dropout)

        if c.gpr:
            xs = [
                jax.nn.relu(
                    MLP(
                        hidden_channels=c.mlp_hidden,
                        out_channels=c.mlp_hidden,
                        num_layers=c.mlp_num_layers,
                        dropout=c.dropout,
                        normalization=c.normalization,
                        input_norm=False,
                        name="gpr_mlp",
                    )(x, train)
                )
            ]
            h = x
            for i in range(c.all_num_layers):
                h = v2e(i, h)  # relu folded into the half-layer
                h = drop(h, deterministic=not train)
                h = e2v(i, h)
                xs.append(h)
                h = drop(h, deterministic=not train)
            stacked = jnp.stack(xs, axis=-1)  # [N, hid, L+1]
            weights = TorchDense(1, use_bias=False, name="GPRweights")
            h = weights(stacked).squeeze(-1)
            return classifier(h, train).astype(jnp.float32)

        h = core.Dropout(0.2)(x, deterministic=not train)  # fixed input dropout
        for i in range(c.all_num_layers):
            h = v2e(i, h)  # relu folded into the half-layer
            h = drop(h, deterministic=not train)
            h = e2v(i, h)
            h = drop(h, deterministic=not train)
        return classifier(h, train).astype(jnp.float32)
