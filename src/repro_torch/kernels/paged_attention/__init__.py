from .kernel import paged_attention_kernel
from .ops import paged_attention
from .ref import paged_attention_plain, reference_paged_attention

__all__ = ["paged_attention", "paged_attention_kernel", "paged_attention_plain",
           "reference_paged_attention"]
