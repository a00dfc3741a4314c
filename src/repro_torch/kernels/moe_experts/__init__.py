from .kernel import (KINDS, RouteBackwardPlan, RoutePlan, data_grad_plan, launch_kind,
                     library_plan, moe_combine_backward_kernel, moe_combine_kernel,
                     moe_down_grad_kernel, moe_experts_kernel, moe_route_backward_kernel,
                     moe_route_kernel, moe_up_grad_kernel, moe_weight_grad_kernel,
                     route_backward_plan, route_plan, weight_grad_plan)
from .ops import (ROUTE_OBSERVERS, MoEFFN, combine, expert_ffn, layer_forward,
                  layer_forward_shard, moe_layer, route)
from .ref import (ExpertGrads, Route, moe_combine_backward_plain, moe_combine_partial_plain,
                  moe_combine_plain, moe_down_grad_plain, moe_experts_backward_plain,
                  moe_experts_plain, moe_gather_backward_plain, moe_route_backward_plain,
                  moe_route_plain, moe_router_plain, moe_shard_partial_plain, moe_shards_plain,
                  moe_up_grad_plain, moe_weight_grad_plain, route_logits_plain, route_sort_plain,
                  shard_kept, top_k_lower_first)

__all__ = ["ExpertGrads", "KINDS", "MoEFFN", "ROUTE_OBSERVERS", "Route", "RouteBackwardPlan",
           "RoutePlan", "combine", "data_grad_plan", "expert_ffn", "launch_kind", "layer_forward",
           "layer_forward_shard", "library_plan", "moe_combine_backward_kernel",
           "moe_combine_backward_plain", "moe_combine_kernel", "moe_combine_partial_plain",
           "moe_combine_plain", "moe_down_grad_kernel", "moe_down_grad_plain",
           "moe_experts_backward_plain", "moe_experts_kernel", "moe_experts_plain",
           "moe_gather_backward_plain", "moe_layer", "moe_route_backward_kernel",
           "moe_route_backward_plain", "moe_route_kernel", "moe_route_plain", "moe_router_plain",
           "moe_shard_partial_plain", "moe_shards_plain", "moe_up_grad_kernel",
           "moe_up_grad_plain", "moe_weight_grad_kernel", "moe_weight_grad_plain", "route",
           "route_backward_plan", "route_logits_plain", "route_plan", "route_sort_plain",
           "shard_kept", "top_k_lower_first", "weight_grad_plan"]
