"""qwen3-moe-235b-a22b [moe] — 128 experts top-8 [hf:Qwen/Qwen3 MoE family].

94L d_model=4096 64H (GQA kv=4) expert d_ff=1536 vocab=151936, qk_norm.
Deepest assigned arch: scan-over-layers is mandatory (94 layers).
Full attention -> long_500k skipped.
"""

from ..models.config import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    n_layers=94,
    d_model=4096,
    n_heads=64,
    n_kv_heads=4,
    d_ff=1536,        # expert width
    vocab=151936,
    head_dim=128,
    mlp="swiglu",
    norm="rmsnorm",
    qk_norm=True,
    rope_theta=1_000_000.0,
    moe=MoEConfig(n_experts=128, top_k=8, d_expert=1536, capacity_factor=1.25),
    shapes=("train_4k", "prefill_32k", "decode_32k"),
)
