"""starcoder2-3b [dense] — GQA kv=2, RoPE, sliding window 4096
[arXiv:2402.19173; hf].  30L d_model=3072 24H d_ff=12288 vocab=49152.
LayerNorm + standard gelu MLP, attention bias (per the HF config).
Sliding-window attention is sub-quadratic -> runs long_500k.
"""

from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="starcoder2-3b",
    family="dense",
    n_layers=30,
    d_model=3072,
    n_heads=24,
    n_kv_heads=2,
    d_ff=12288,
    vocab=49152,
    mlp="gelu",
    norm="layernorm",
    qkv_bias=True,
    rope_theta=999_999.4420358813,
    sliding_window=4096,
    shapes=("train_4k", "prefill_32k", "decode_32k", "long_500k"),
)
