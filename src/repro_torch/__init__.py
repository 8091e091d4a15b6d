"""`repro_torch` — Active Search for Nearest Neighbors in PyTorch + CUDA.

The PyTorch port of the JAX + Pallas package `repro`, laid out file for file
beside it (`repro_torch/core/grid.py` mirrors `repro/core/grid.py`, and so
on).  It imports `torch` and `numpy` only — never `jax`, never `repro`.
The JAX package stays the reference: the port's tests run both packages on
the same numpy inputs and hold the port to the reference's results.

Backend names (the `ExecutionPlan.backend` registry) map from the reference
as follows:

    reference        port
    ---------        ----
    jnp              torch
    pallas           hopper          (this package's default plan)
    pallas_gather    hopper_gather
    pallas_q8        hopper_q8
    pallas_stacked   hopper_stacked
    exact            exact
    sharded          sharded

Registered: `hopper` (the batched main path on the hand-written Hopper
kernels in `repro_torch/csrc/`, the default), `hopper_gather` (the
materialised-window candidate stage, a baseline and second oracle),
`hopper_q8` (the int8 shortlist and its exact float32 re-rank),
`hopper_stacked` (count_at only, one `tile_count` launch per pyramid level),
`torch` (the per-query pipeline in plain PyTorch, the whole batch in lock
step: no kernel), `exact` (the brute-force comparator; its l2 route is
the `brute_knn` kernel) and `sharded` (on an `ActiveSearcher.build_sharded`
handle: one grid per shard, all on one device, each searched on `torch`
as the reference's shards search on `jnp`, the top-k lists merged by
(distance, global id); `core/distributed.py`).  `flash_attention` has a
kernel too, which no path calls yet.

Mutation: `ActiveSearcher.insert` / `.delete` / `.snapshot` keep a
`core/mutable.py` state beside the handle's index (one per shard on a
sharded handle, routed by grid-cell ownership) and return new handles;
every backend but `hopper_stacked` serves them (`supports_mutation`).

Serving: `core/knn_lm.py` (the kNN-LM head), `core/retrieval_memory.py`
(retrieval-augmented attention memory), `checkpoint/store.py`
(`CheckpointManager`, the reference's on-disk format) and
`launch/serve.py` (`DynamicBatcher`, the dynamic batching queue).

Devices: the entry points (`api.ActiveSearcher.build`, `.from_index`,
`convert.index_from_numpy`, `convert.mutable_from_numpy`, ...) take
`device=None`, which means "cuda".
Without a card they raise unless the caller passes `device="cpu"`; on the
CPU every kernel wrapper runs its plain PyTorch version instead
(`repro_torch/kernels/ops.py`).

    from repro_torch import api
    s = api.ActiveSearcher.build(points, labels=labels,
                                 cfg=api.GridConfig(n_classes=3))
    res = s.search(queries, k=11)
"""
