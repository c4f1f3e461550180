"""PDET-LSH / DET-LSH in PyTorch, with hand-written CUDA kernels for the
H100 (sm_90a).

The port of the JAX package ``repro``, slice by slice; it imports neither
JAX nor ``repro``.  It carries the static DET-LSH build, both c^2-k-ANN
engines (fused and per-query), the streaming mutable index
(``repro_torch.api``: ``IndexSpec`` -> ``build`` -> ``search`` ->
``save``/``load``; ``upsert``/``delete``/``maybe_compact`` on the
streaming kind), the sharded PDET index and LSH attention decode over a
KV cache (``repro_torch.decode``).  Entry points run on CUDA unless given
``device=``.

Subpackages: core, kernels, api, baselines, streaming, launch, decode.
"""
