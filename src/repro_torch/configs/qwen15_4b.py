"""qwen1.5-4b [dense] — MHA with QKV bias. [hf:Qwen/Qwen1.5-4B]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-4b", family="dense",
    n_layers=40, d_model=2560, n_heads=20, n_kv_heads=20, d_ff=6912,
    vocab=151936, head_dim=128, qkv_bias=True,
)
