from .kernel import paged_attention_kernel
from .ops import paged_attention
from .ref import (merge_partials, paged_attention_plain, paged_attention_split_plain,
                  reference_paged_attention)

__all__ = ["merge_partials", "paged_attention", "paged_attention_kernel",
           "paged_attention_plain", "paged_attention_split_plain",
           "reference_paged_attention"]
