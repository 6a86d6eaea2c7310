"""Serving runtime (counterpart of ``repro.serve``).

Two serving surfaces live here:

* ``serve.frontend`` -- the batched index front-end: request queue ->
  adaptive batcher -> one tenant-stacked dispatch (one launch of the
  shard-stacked K2 for the batch's finds, one of K3 for its ranges, over
  every tenant's shards) -> response scatter.  The batcher coalesces
  requests up to a latency budget (from the oldest queued request, with
  an early cut at the batch-size cap) and pads the live batch to pow2
  capacity classes; inserts and deletes interleave with finds in the same
  batches and apply before them; tenants run their drift maintenance in
  the idle windows.
* ``serve.step`` and ``serve.kvcache`` -- LM prefill and decode steps on
  one device, the paged KV cache, its learned page table
  (``learned_page_table``, static) and ``DynamicPageTable`` (the two-tier
  dynamic index under allocation and release).
"""
