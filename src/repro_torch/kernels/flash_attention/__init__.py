from .kernel import flash_attention_kernel
from .ops import flash_attention
from .ref import flash_attention_plain

__all__ = ["flash_attention", "flash_attention_kernel", "flash_attention_plain"]
