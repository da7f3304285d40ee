"""``repro_torch`` — the PyTorch/CUDA port of the ``repro`` package.

Same sub-package layout and public names as ``repro`` (the JAX reference),
so the counterpart of a module is found by path.  The port imports
``torch`` and numpy only: never ``jax`` and nothing of ``repro``; it keeps
its own copy of every control-plane module it needs.

Ported so far: the paged-KV serving path — ``launch.serve`` →
``serving.engine.ServingEngine`` → ``memory.kv_cache.PagedKVManager`` /
``vmem.Pager`` → ``models.decoder.decode_step`` →
``models.attention.apply_attention_decode_paged`` — and the training path
(``launch.train`` → ``training.trainer``), with hand-written CUDA kernels
under ``kernels/`` (paged decode attention, page gather, page scatter,
flash attention); the verbs fabric and its simulator (``api``, ``core``,
``net``, ``npr``, ``tenancy``, ``testing``), remote paging
(``vmem.RemoteFramePool``), the static lint passes (``lint``, run by
``python -m repro_torch.lint``) and the distribution layer
(``distributed``: partition rules, logical axes, pipeline, compression,
fault tolerance, and the shard-local paged decode under a mesh).  Entry points run on the GPU unless
``device="cpu"`` is passed (``compat.resolve_device``).
"""
