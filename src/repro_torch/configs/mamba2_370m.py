"""mamba2-370m [ssm] — SSD (state-space duality), attention-free.
[arXiv:2405.21060]"""
from repro_torch.models.config import ModelConfig, SSM

CONFIG = ModelConfig(
    name="mamba2-370m", family="ssm",
    n_layers=48, d_model=1024, n_heads=0, n_kv_heads=0, d_ff=0,
    vocab=50280,
    pattern_period=(SSM,), ssm_state=128, ssm_headdim=64, ssm_groups=1,
    expand=2, tie_embeddings=True,
)
