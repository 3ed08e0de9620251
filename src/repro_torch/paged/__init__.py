# Paged KV cache: host-side page bookkeeping (page_manager.py, a copy of
# the reference's), the device pools with in-place scatter/gather
# (paged_cache.py) and the layer-level paged decode (attention.py), whose
# attention is the hand-written kernel B4 (kernels/paged_attention.py).
from repro_torch.paged.attention import paged_attention_decode
from repro_torch.paged.page_manager import (PageManager, PageManagerStats,
                                            PagePoolExhausted)
from repro_torch.paged.paged_cache import (append_decode, copy_pages,
                                           gather_kv, init_pool, pool_pages,
                                           pool_token_bytes, scatter_prefill)

__all__ = ["PageManager", "PageManagerStats", "PagePoolExhausted",
           "init_pool", "pool_pages", "pool_token_bytes", "scatter_prefill",
           "append_decode", "gather_kv", "copy_pages",
           "paged_attention_decode"]
