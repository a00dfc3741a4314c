"""moonshot-v1-16b-a3b [moe] — kimi/moonlight, 64 experts top-6
[hf:moonshotai/Moonlight-16B-A3B].

48L d_model=2048 16H (kv=16) expert d_ff=1408 vocab=163840, MoE 64e top-6,
plus a deepseek-style shared expert (2x1408) — toggled by the name prefix in
models/moe.py.  Full attention -> long_500k skipped.
"""

from ..models.config import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,        # expert width (shared expert = 2x)
    vocab=163840,
    mlp="swiglu",
    norm="rmsnorm",
    rope_theta=50000.0,
    moe=MoEConfig(n_experts=64, top_k=6, d_expert=1408, capacity_factor=1.25),
    shapes=("train_4k", "prefill_32k", "decode_32k"),
)
