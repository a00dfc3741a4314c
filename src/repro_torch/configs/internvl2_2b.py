"""internvl2-2b [vlm] — InternViT + InternLM2 backbone [arXiv:2404.16821; hf].

24L d_model=2048 16H (GQA kv=8) d_ff=8192 vocab=92553.  The InternViT-300M
frontend is a stub: ``input_specs`` provides precomputed 1024-dim patch
embeddings (256 patches = one 448px tile).  Backbone is full attention ->
long_500k is skipped (DESIGN.md §Arch-applicability).
"""

from ..models.config import ArchConfig, VLMConfig

CONFIG = ArchConfig(
    name="internvl2-2b",
    family="vlm",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    d_ff=8192,
    vocab=92553,
    mlp="swiglu",
    norm="rmsnorm",
    rope_theta=1_000_000.0,
    vlm=VLMConfig(n_patches=256, patch_dim=1024),
    shapes=("train_4k", "prefill_32k", "decode_32k"),
)
