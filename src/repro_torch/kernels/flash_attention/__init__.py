from .kernel import flash_attention_backward_kernel, flash_attention_kernel
from .ops import FlashAttention, flash_attention
from .ref import flash_attention_backward_plain, flash_attention_plain

__all__ = ["FlashAttention", "flash_attention", "flash_attention_backward_kernel",
           "flash_attention_backward_plain", "flash_attention_kernel", "flash_attention_plain"]
