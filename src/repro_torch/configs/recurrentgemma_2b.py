"""recurrentgemma-2b [hybrid] — RG-LRU + local attention, pattern (R,R,L).
[arXiv:2402.19427]"""
from repro_torch.models.config import ModelConfig, RECURRENT, ATTN_LOCAL

CONFIG = ModelConfig(
    name="recurrentgemma-2b", family="hybrid",
    n_layers=26, d_model=2560, n_heads=10, n_kv_heads=1, d_ff=7680,
    vocab=256000, head_dim=256,
    pattern_period=(RECURRENT, RECURRENT, ATTN_LOCAL), window=2048,
    lru_width=2560, tie_embeddings=True,
    # every attention layer here is local: with attn_backend="pallas",
    # attn_sparse="auto" takes the block-sparse live-index kernel for
    # window=2048 prefill past ~4k tokens (below that the dense grid is
    # already mostly live)
    attn_sparse="auto",
)
