"""seamless-m4t-large-v2 [audio] — enc-dec; audio frontend is a stub
providing precomputed frame embeddings. [arXiv:2308.11596]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2", family="audio",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16, d_ff=8192,
    vocab=256206, head_dim=64,
    is_encdec=True, n_enc_layers=24, frontend="audio",
)
