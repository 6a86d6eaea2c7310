"""LM serving on one device: prefill and decode steps, the paged-KV cache
and its learned page table."""
