# Paged KV cache: host-side page bookkeeping (page_manager.py, a copy of
# the reference's), the device pools with in-place scatter/gather
# (paged_cache.py) and the layer-level paged decode (attention.py), whose
# attention is the hand-written kernel B4 (kernels/paged_attention.py),
# with its T-query twin for the speculative-decode verify.
from repro_torch.paged.attention import (paged_attention_decode,
                                         paged_attention_decode_multi,
                                         paged_attention_reference_multi)
from repro_torch.paged.page_manager import (PageManager, PageManagerStats,
                                            PagePoolExhausted)
from repro_torch.paged.paged_cache import (append_decode,
                                           append_decode_multi, copy_pages,
                                           gather_kv, init_pool, pool_pages,
                                           pool_token_bytes, scatter_prefill)

__all__ = ["PageManager", "PageManagerStats", "PagePoolExhausted",
           "init_pool", "pool_pages", "pool_token_bytes", "scatter_prefill",
           "append_decode", "append_decode_multi", "gather_kv",
           "copy_pages", "paged_attention_decode",
           "paged_attention_decode_multi", "paged_attention_reference_multi"]
