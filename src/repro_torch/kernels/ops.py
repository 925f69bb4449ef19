"""Public wrappers of the ported kernel families (mirrors
`repro.kernels.ops` for the ops the paged serving path runs).

``cfg`` is a CoarseningConfig or a label ("con2", "gap4+simd2", "base");
``"auto"`` resolves to the uncoarsened config until the tuner is ported.
Tensors on the CPU take each kernel's plain PyTorch version; tensors on a
CUDA device take the hand-written kernel (or the call raises).
"""
from __future__ import annotations

from repro_torch.core.coarsening import BASE, CoarseningConfig
from repro_torch.kernels import decode_attention as _decode
from repro_torch.kernels import matmul as _matmul


def matmul(a, b, cfg: CoarseningConfig | str = BASE):
    """(m,k) @ (k,n) -> (m,n) float32 through the coarsened blocked kernel."""
    return _matmul.coarsened_matmul(a, b, cfg)


def paged_decode_attention(q, k_pool, v_pool, block_table, pos,
                           cfg: CoarseningConfig | str = BASE, *,
                           window: int | None = None,
                           scale: float | None = None,
                           k_scale=None, v_scale=None):
    """Split-KV decode attention through a per-slot block table.
    q: (B,1,H,D); pools: (P,page_size,Hkv,D); block_table: (B,npp) int32;
    pos: (B,) int32 -> (B,1,H,D).  The coarsening axis is the slot's
    logical-page axis."""
    return _decode.paged_decode_attention(
        q, k_pool, v_pool, block_table, pos, cfg, window=window, scale=scale,
        k_scale=k_scale, v_scale=v_scale)
