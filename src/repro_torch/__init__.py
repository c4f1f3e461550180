"""PDET-LSH / DET-LSH in PyTorch, with hand-written CUDA kernels for the
H100 (sm_90a).

The port of the JAX package ``repro``, slice by slice; it imports neither
JAX nor ``repro``.  This slice carries the static DET-LSH build and the
fused c^2-k-ANN search (``repro_torch.api``: ``IndexSpec`` -> ``build`` ->
``search`` -> ``save``/``load``).  Entry points run on CUDA unless given
``device=``.

Subpackages: core, kernels, api, baselines.
"""
