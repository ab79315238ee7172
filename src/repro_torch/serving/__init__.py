from repro_torch.serving.engine import (cache_abstract, cache_batch_axes,
                                        greedy_generate, make_prefill_step,
                                        make_serve_step, pad_cache,
                                        sample_logits)
from repro_torch.serving.paged_cache import (BlockAllocator, PoolExhausted,
                                             n_blocks_for, paged_cache_init,
                                             paged_kv_bytes_per_block,
                                             set_block_table, splice_prefill)
from repro_torch.serving.scheduler import PagedScheduler, ServeRequest

__all__ = ["cache_abstract", "cache_batch_axes", "greedy_generate",
           "make_prefill_step", "make_serve_step", "pad_cache", "sample_logits",
           "BlockAllocator", "PoolExhausted", "n_blocks_for",
           "paged_cache_init", "paged_kv_bytes_per_block", "set_block_table",
           "splice_prefill", "PagedScheduler", "ServeRequest"]
