"""whisper-base [audio] — enc-dec, conv frontend stub [arXiv:2212.04356].

6L decoder (+6L encoder) d_model=512 8H d_ff=2048 vocab=51865.
``input_specs`` provides precomputed 1500-frame embeddings (the output of
whisper's two conv layers over a 30 s mel spectrogram).  Enc-dec with a
decoder -> decode shapes run; full attention -> long_500k skipped.
"""

from ..models.config import ArchConfig, EncDecConfig

CONFIG = ArchConfig(
    name="whisper-base",
    family="audio",
    n_layers=6,               # decoder layers
    d_model=512,
    n_heads=8,
    n_kv_heads=8,
    d_ff=2048,
    vocab=51865,
    mlp="gelu",
    norm="layernorm",
    tie_embeddings=True,
    encdec=EncDecConfig(n_encoder_layers=6, n_frames=1500, frame_dim=512),
    shapes=("train_4k", "prefill_32k", "decode_32k"),
)
