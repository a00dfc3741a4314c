from .kernel import paged_attention_kernel
from .ops import (merge_shard_states, paged_attention, paged_shard_partials, pool_shard,
                  sharded_paged_attention, sharded_paged_attention_local)
from .ref import (merge_partials, paged_attention_plain, paged_attention_split_plain,
                  reference_paged_attention)

__all__ = ["merge_partials", "merge_shard_states", "paged_attention",
           "paged_attention_kernel", "paged_attention_plain", "paged_attention_split_plain",
           "paged_shard_partials", "pool_shard", "reference_paged_attention",
           "sharded_paged_attention", "sharded_paged_attention_local"]
