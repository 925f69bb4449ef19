"""qwen2-moe-a2.7b [moe] — 60 routed top-4 + 4 shared experts.
[hf:Qwen/Qwen1.5-MoE-A2.7B]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b", family="moe",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=16, d_ff=1408,
    vocab=151936, head_dim=128, qkv_bias=True,
    n_experts=60, top_k=4, moe_d_ff=1408, n_shared_experts=4,
)
