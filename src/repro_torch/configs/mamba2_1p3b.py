"""mamba2-1.3b [ssm] — SSD (state-space duality) [arXiv:2405.21060].

48L d_model=2048 attention-free, ssm_state=128.  d_inner = 2*d_model = 4096,
64 heads of dim 64.  O(1) decode state -> runs long_500k.
"""

from ..models.config import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="mamba2-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=64,       # ssd heads (d_inner / head_dim)
    n_kv_heads=64,
    d_ff=0,           # attention/MLP-free: the ssd block is the whole layer
    vocab=50280,
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64, chunk=256),
    shapes=("train_4k", "prefill_32k", "decode_32k", "long_500k"),
)
