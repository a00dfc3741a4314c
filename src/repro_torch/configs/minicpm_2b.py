"""minicpm-2b [dense] — WSD schedule, mup-style scaling [arXiv:2404.06395; hf].

40L d_model=2304 36H (kv=36, i.e. MHA) d_ff=5760 vocab=122753.
Llama-like block; the MiniCPM specifics are the WSD learning-rate schedule
(``train/optim.py::wsd_schedule``, which ``launch/train.py`` selects for this
arch with the preset below) and the depth/width scaling factors:
scale_emb=12, scale_depth=1.4 (residual scale 1.4/sqrt(40)), logit scale =
1/(2304/256).
"""

import math

from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="minicpm-2b",
    family="dense",
    n_layers=40,
    d_model=2304,
    n_heads=36,
    n_kv_heads=36,
    d_ff=5760,
    vocab=122753,
    mlp="swiglu",
    norm="rmsnorm",
    emb_scale=12.0,
    residual_scale=1.4 / math.sqrt(40),
    logit_scale=256.0 / 2304.0,
    tie_embeddings=True,
    rope_theta=10000.0,
    shapes=("train_4k", "prefill_32k", "decode_32k"),
)

# WSD (warmup-stable-decay) schedule preset: warmup as a fraction of the run,
# the share of the rest at peak, the floor.  Kept as the JAX package keeps
# its own: ``launch/train.py::optim_config`` builds the config the JAX
# package's ``run_training`` builds, a tenth of the run as warmup, and reads
# no preset.
WSD = {"warmup_steps": 0.01, "stable_frac": 0.9, "min_ratio": 0.1}
