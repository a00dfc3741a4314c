from .kernel import library_plan, moe_experts_kernel, moe_router_kernel
from .ops import expert_ffn, router_logits
from .ref import moe_experts_plain, moe_router_plain

__all__ = ["expert_ffn", "library_plan", "moe_experts_kernel", "moe_experts_plain",
           "moe_router_kernel", "moe_router_plain", "router_logits"]
