"""recurrentgemma-2b [hybrid] — RG-LRU + local attn 1:2 [arXiv:2402.19427; hf].

26L d_model=2560 10H (MQA kv=1) d_ff=7680 vocab=256000, lru_width=2560,
local attention window 2048, pattern rra (2 recurrent : 1 attention).
O(1) recurrent state + bounded window -> runs long_500k.
"""

from ..models.config import ArchConfig, HybridConfig

CONFIG = ArchConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    n_layers=26,
    d_model=2560,
    n_heads=10,
    n_kv_heads=1,
    d_ff=7680,
    vocab=256000,
    head_dim=256,
    mlp="geglu",
    norm="rmsnorm",
    tie_embeddings=True,
    rope_theta=10000.0,
    hybrid=HybridConfig(pattern="rra", lru_width=2560, local_window=2048, d_conv=4),
    shapes=("train_4k", "prefill_32k", "decode_32k", "long_500k"),
)
