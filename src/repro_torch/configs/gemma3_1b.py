"""gemma3-1b [dense] — 5:1 local:global attention, 128k ctx.
[hf:google/gemma-3-1b-pt]"""
from repro_torch.models.config import ModelConfig, ATTN_LOCAL, ATTN_GLOBAL

CONFIG = ModelConfig(
    name="gemma3-1b", family="dense",
    n_layers=26, d_model=1152, n_heads=4, n_kv_heads=1, d_ff=6912,
    vocab=262144, head_dim=256,
    pattern_period=(ATTN_LOCAL,) * 5 + (ATTN_GLOBAL,), window=512,
    rope_theta=1e6, tie_embeddings=True,
    # the 5:1 local layers are the block-sparse prefill target: with
    # attn_backend="pallas", attn_sparse="auto" routes window=512 prefill
    # through the live-index kernel (long-context gate: at 32k ctx the
    # index visits ~26x fewer kv blocks than the dense causal grid)
    attn_sparse="auto",
)
