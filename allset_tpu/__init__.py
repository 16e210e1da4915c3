"""allset_tpu: a JAX hypergraph neural network framework.

A from-scratch JAX/XLA re-design of the capability surface of the AllSet
reference codebase (jianhao2016/AllSet — "You are AllSet: A Multiset
Function Framework for Hypergraph Neural Networks", ICLR 2022).

Everything is built around one load-bearing idea:

* A hypergraph is a **static-shape sparse incidence** (COO over
  (node, hyperedge) pairs, padded to a static bucket).
* Every model in the AllSet family reduces to four primitive ops over that
  incidence: row gather, segment-reduce (SpMM), segment-softmax (for
  attention pooling), and dense GEMMs — all of which XLA compiles for the
  GPU as they stand.
* Multi-device scaling is incidence **edge partitioning** over a
  ``jax.sharding.Mesh`` (`allset_tpu.parallel`), not a port of any
  torch.distributed machinery (the reference has none).

Layout:
  ops/       sorted segment ops over the incidence, the compute core
  graph/     Incidence pytree + host-side hypergraph transforms
  nn/        module layer (core.py) + neural modules (MLP, PMA, HalfNLHconv)
  models/    SetGNN (AllSetTransformer / AllDeepSets) + baseline families
  data/      dataset loaders, synthetic generators, caching, splits
  train/     jitted full-batch trainer, logger, evaluation
  parallel/  mesh construction + edge-partitioned distributed step
"""

__version__ = "0.1.0"

from allset_tpu.graph.incidence import Incidence  # noqa: F401
