"""Plain PyTorch versions of the kernels on the paged serving path.

Each computes its kernel's function in one untiled shot, as
`repro.kernels.ref` does for the Pallas kernels: the CPU path of every
wrapper, and the yardstick each CUDA kernel is held against on the card.
Coarsening redistributes work between thread blocks; it must not change
these results.
"""
from __future__ import annotations

import math

import torch

NEG = -1e30


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(m,k) @ (k,n) in float32 (`repro/kernels/ref.py:44`)."""
    return torch.matmul(a.float(), b.float())


def decode_attention(q, k_cache, v_cache, pos, *, window=None, scale=None):
    """Dense full-length decode attention in float32
    (`repro/kernels/ref.py:102`).  q: (B,1,H,D); caches: (B,S,Hkv,D);
    pos: (B,) int -> (B,1,H,D) in q's dtype."""
    b, _, h, d = q.shape
    s, hkv = k_cache.shape[1], k_cache.shape[2]
    g = h // hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    qg = q.reshape(b, hkv, g, d).float()
    logits = torch.einsum("bhgd,bshd->bhgs", qg, k_cache.float()) * scale
    kpos = torch.arange(s, device=q.device)
    pos = pos.to(torch.int64)
    mask = kpos[None, :] <= pos[:, None]
    if window is not None:
        mask = mask & (kpos[None, :] > pos[:, None] - window)
    logits = torch.where(mask[:, None, None, :], logits,
                         torch.full_like(logits, NEG))
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgs,bshd->bhgd", p, v_cache.float())
    return out.reshape(b, 1, h, d).to(q.dtype)


def gather_pages(pool, block_table):
    """(P,ps,Hkv,D) pool + (B,npp) table -> the slots' contiguous
    (B, npp*ps, Hkv, D) views (`repro/kernels/ops.py:460-467`)."""
    b, npp = block_table.shape
    _, ps, hkv, d = pool.shape
    return pool[block_table.long()].reshape(b, npp * ps, hkv, d)


def paged_decode_attention(q, k_pool, v_pool, block_table, pos, *,
                           window=None, scale=None):
    """Gather-to-contiguous oracle of the paged split-KV kernel: resolve the
    block table, then dense decode attention."""
    return decode_attention(q, gather_pages(k_pool, block_table),
                            gather_pages(v_pool, block_table), pos,
                            window=window, scale=scale)


def paged_split_kv(q, k_pool, v_pool, block_table, pos, *, degree=1,
                   gapped=False, window=None, scale=None):
    """The paged split-KV kernel's own arithmetic, in one shot per split
    (`repro/kernels/decode_attention.py:208` `make_paged_kernel`): split
    ``si`` owns logical pages ``si*C + j`` (consecutive) or
    ``j*(npp/C) + si`` (gapped), resolved through the block table; a split
    wholly past ``pos`` (or left of the window) yields the empty partial;
    rows past ``pos`` are masked; `combine` merges the splits.
    q: (B,1,H,D); pools: (P,ps,Hkv,D); block_table: (B,npp); pos: (B,)
    -> (B,1,H,D) in q's dtype."""
    b, _, h, d = q.shape
    _, ps, hkv, _ = k_pool.shape
    npp = block_table.shape[1]
    c, g = degree, h // hkv
    n_splits = seg = npp // c
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    dev = q.device
    si = torch.arange(n_splits, device=dev)[:, None]
    j = torch.arange(c, device=dev)[None, :]
    lp = j * seg + si if gapped else si * c + j               # (n_splits, C)
    phys = block_table.long()[:, lp]                           # (B,n,C)

    def panes(pool):                                           # (B,Hkv,n,C*ps,D)
        x = pool[phys].float()                                 # (B,n,C,ps,Hkv,D)
        return x.permute(0, 4, 1, 2, 3, 5).reshape(b, hkv, n_splits,
                                                   c * ps, d)

    cols = (lp[..., None] * ps + torch.arange(ps, device=dev)
            ).reshape(n_splits, c * ps)
    pos = pos.to(torch.int64)[:, None, None]                   # (B,1,1)
    mask = cols[None] <= pos                                   # (B,n,C*ps)
    if window is not None:
        mask = mask & (cols[None] > pos - window)
    first, last = cols.amin(dim=1), cols.amax(dim=1)           # (n,)
    live = first[None] <= pos[:, :, 0]                         # (B,n)
    if window is not None:
        live = live & (last[None] > pos[:, :, 0] - window)
    mask = mask & live[..., None]
    qg = q.reshape(b, hkv, g, d).float()
    s = torch.einsum("bhgd,bhnkd->bhgnk", qg, panes(k_pool)) * scale
    mk = mask[:, None, None]                                   # (B,1,1,n,C*ps)
    s = torch.where(mk, s, torch.full_like(s, NEG))
    m = s.amax(dim=-1)                                         # (B,Hkv,G,n)
    p = torch.exp(s - m[..., None]) * mk
    l = p.sum(dim=-1)
    acc = torch.einsum("bhgnk,bhnkd->bhgnd", p, panes(v_pool))
    out = combine(m, l, acc)                                   # (B,Hkv,G,D)
    return out.reshape(b, 1, h, d).to(q.dtype)


def combine(m, l, acc):
    """Merge per-split partial softmax states exactly
    (`repro/kernels/decode_attention.py:37` `_combine`).
    m, l: (B,Hkv,G,n_splits); acc: (B,Hkv,G,n_splits,D) -> (B,Hkv,G,D)."""
    m_max = m.amax(dim=-1)
    w = torch.exp(m - m_max[..., None])
    w = torch.where(m <= NEG * 0.5, torch.zeros_like(w), w)
    l_tot = (l * w).sum(dim=-1)
    out = (acc * w[..., None]).sum(dim=-2)
    l_tot = torch.where(l_tot == 0.0, torch.ones_like(l_tot), l_tot)
    return out / l_tot[..., None]
