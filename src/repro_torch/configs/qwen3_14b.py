"""qwen3-14b [dense] — qk_norm, GQA kv=8 [hf:Qwen/Qwen3-8B family].

40L d_model=5120 40H d_ff=17408 vocab=151936, head_dim=128.
Full attention -> long_500k skipped.
"""

from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-14b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=17408,
    vocab=151936,
    head_dim=128,
    mlp="swiglu",
    norm="rmsnorm",
    qk_norm=True,
    rope_theta=1_000_000.0,
    shapes=("train_4k", "prefill_32k", "decode_32k"),
)
