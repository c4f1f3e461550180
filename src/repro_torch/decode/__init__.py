"""DET-LSH attention decode: the KV cache as an index.

The KV cache is a ``repro_torch.api.MutableAnnIndex`` (``KVCacheIndex``):
prefill is a batched per-head build, each decode step is a delta upsert
plus one batched fused ``range_rerank_heads`` retrieval, and
``sparse_decode_attention`` computes exact softmax over the retrieved ∪
window ∪ sink positions.  The MIPS -> L2 reduction (``decode.mips``) is the
thin transform layer between attention scores and the Euclidean engine.
"""

from repro_torch.decode.mips import (DEFAULT_SLACK, augment_keys,
                                     augment_queries, mips_radius)
from repro_torch.decode.kv_index import (HeadForest, KVCacheIndex,
                                         KVRetrieval, KVSpec)
from repro_torch.decode.attention import LSHDecoder, sparse_decode_attention

__all__ = ["KVCacheIndex", "KVSpec", "KVRetrieval", "HeadForest",
           "LSHDecoder", "sparse_decode_attention", "mips_radius",
           "augment_keys", "augment_queries", "DEFAULT_SLACK"]
