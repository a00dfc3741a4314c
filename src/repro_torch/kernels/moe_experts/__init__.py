from .kernel import (RoutePlan, library_plan, moe_combine_kernel, moe_experts_kernel,
                     moe_route_kernel, route_plan)
from .ops import combine, expert_ffn, route
from .ref import (Route, moe_combine_plain, moe_experts_plain, moe_route_plain,
                  moe_router_plain, route_logits_plain, route_sort_plain,
                  top_k_lower_first)

__all__ = ["Route", "RoutePlan", "combine", "expert_ffn", "library_plan", "moe_combine_kernel",
           "moe_combine_plain", "moe_experts_kernel", "moe_experts_plain", "moe_route_kernel",
           "moe_route_plain", "moe_router_plain", "route", "route_logits_plain", "route_plan",
           "route_sort_plain",
           "top_k_lower_first"]
