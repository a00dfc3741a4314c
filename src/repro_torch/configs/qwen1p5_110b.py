"""qwen1.5-110b [dense] — QKV bias [hf:Qwen/Qwen1.5 family].

80L d_model=8192 64H (GQA kv=8) d_ff=49152 vocab=152064.
The largest assigned cell: fp32 masters + Adam state only fit 256 chips with
2-D (FSDP x TP) parameter sharding.  Full attention -> long_500k skipped.
"""

from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="qwen1.5-110b",
    family="dense",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=49152,
    vocab=152064,
    mlp="swiglu",
    norm="rmsnorm",
    qkv_bias=True,
    rope_theta=1_000_000.0,
    shapes=("train_4k", "prefill_32k", "decode_32k"),
)
