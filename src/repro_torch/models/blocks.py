"""The attention + FFN residual block: the whole-sequence block of training
and the paged serving path's blocks.

Mirrors, from `repro/models/blocks.py`:

* `attn_block` (:44-69) — one block over a whole sequence (training);
* `attn_cache_init_paged` (:185) — one global (P, page_size, Hkv, hd) K and
  V pool per layer;
* `_paged_rows` (:202) — physical (page, row) of logical cache rows;
* `attn_block_decode_paged` (:211) — one decode step of a block;
* `attn_block_prefill_paged` (:260) — one prefill chunk of a block.

The reference updates the pools functionally (``cache["k"].at[page,
row].set(...)`` returns a new pool).  Here both block functions write the
new K/V rows INTO the pools in place (``pool[page, row] = rows``) and
return the same dict, so a serving step never copies a pool.  bf16 (or
float32) pools only: int8 pools raise NotImplementedError.
"""
from __future__ import annotations

import torch

from repro_torch.models import layers as L
from repro_torch.models.config import ATTN_LOCAL, ModelConfig


def attn_cache_init_paged(cfg: ModelConfig, num_pages: int, page_size: int,
                          dtype=torch.bfloat16, device=None):
    """Zeroed K and V pools, (num_pages, page_size, Hkv, hd) each.  Page 0
    is the NULL page: never allocated; inactive slots' writes land there."""
    if cfg.kv_quant == "int8":
        raise NotImplementedError("paged cache: int8 KV pools are not ported "
                                  "yet")
    shape = (num_pages, page_size, cfg.n_kv_heads, cfg.hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _paged_rows(block_table, pos, page_size):
    """Physical (page, row) for logical cache rows ``pos`` ((B,) or (B,T)).
    The logical page index is clamped to the table, as JAX clamps an
    out-of-bounds gather: a row past a slot's table resolves to its last
    entry, which for a nulled (inactive) row is the NULL page."""
    npp = block_table.shape[1]
    pos = pos.long()
    bidx = torch.arange(block_table.shape[0], device=block_table.device)
    if pos.dim() == 2:
        bidx = bidx[:, None]
    lp = torch.clamp(pos // page_size, max=npp - 1)
    return block_table.long()[bidx, lp], pos % page_size


def _ffn_out(p, x, cfg: ModelConfig):
    if cfg.n_experts:
        raise NotImplementedError("MoE layers are not ported yet")
    h = L.rmsnorm(p["ln2"], x, cfg.norm_eps)
    return x + L.ffn(p["ffn"], h, backend=cfg.ffn_backend)


def attn_block(p, x, cfg: ModelConfig, *, kind: str, pos,
               pos_trivial: bool = False):
    """One block over whole sequences.  x: (B,S,d); pos: (B,S) positions;
    ``pos_trivial`` says row i IS position i, which lets the flash kernel's
    causal mask stand in for the positions.  Attention dispatches through
    `layers.flash_attention` with the config's attn_* knobs; the FFN is
    dense (MoE raises).  Returns x only: the reference's second output is
    the MoE auxiliary loss, 0 for dense blocks."""
    window = cfg.window if kind == ATTN_LOCAL else None
    h = L.rmsnorm(p["ln1"], x, cfg.norm_eps)
    q, k, v = L.qkv_project(p["attn"], h, cfg, pos)
    o = L.flash_attention(
        q, k, v, causal=True, window=window, q_pos=pos,
        pos_trivial=pos_trivial,
        global_stride=(cfg.attn_global_stride if kind == ATTN_LOCAL
                       else None),
        sparse=cfg.attn_sparse, sparse_cfg=cfg.attn_sparse_cfg,
        backend=cfg.attn_backend, cfg=cfg.attn_cfg,
        bwd_cfg=cfg.attn_bwd_cfg, bq=cfg.attn_bq, bkv=cfg.attn_bkv)
    o = o.reshape(x.shape[0], x.shape[1], -1) @ p["attn"]["wo"].to(x.dtype)
    return _ffn_out(p, x + o, cfg)


def attn_block_decode_paged(p, x, cfg: ModelConfig, cache, *, kind: str, pos,
                            block_table, write_mask=None):
    """One decode step.  x: (B,1,d); cache {'k','v'} pools (P,ps,kv,hd);
    block_table (B,npp) int32; pos (B,).  The new K/V row scatters through
    the table into the pools IN PLACE, then attention reads the pools
    through the same table.  ``write_mask`` (B,) bool routes a slot's write
    to the NULL page.  Returns (x, cache) with ``cache`` the same dict."""
    if "k_scale" in cache:
        raise NotImplementedError("paged decode: int8 KV pools are not "
                                  "ported yet")
    window = cfg.window if kind == ATTN_LOCAL else None
    ps = cache["k"].shape[1]
    h = L.rmsnorm(p["ln1"], x, cfg.norm_eps)
    q, k, v = L.qkv_project(p["attn"], h, cfg, pos[:, None])
    page, row = _paged_rows(block_table, pos, ps)
    if write_mask is not None:
        page = torch.where(write_mask, page, torch.zeros_like(page))
    cache["k"][page, row] = k[:, 0].to(cache["k"].dtype)
    cache["v"][page, row] = v[:, 0].to(cache["v"].dtype)
    o = L.paged_decode_attention(q, cache["k"], cache["v"], block_table, pos,
                                 window=window, backend=cfg.decode_backend,
                                 cfg=cfg.decode_attn_cfg)
    o = o.reshape(x.shape[0], 1, -1) @ p["attn"]["wo"].to(x.dtype)
    return _ffn_out(p, x + o, cfg), cache


def attn_block_prefill_paged(p, x, cfg: ModelConfig, cache, *, kind: str,
                             pos0, block_table):
    """One prefill chunk.  x: (B,T,d); pos0: (B,) chunk start rows.  The
    chunk's K/V rows scatter through the table into the pools IN PLACE;
    attention gathers each slot's logical view back out of the pools and
    runs the chunked plain attention (the reference has no prefill kernel
    on this path).  Non-admitted slots are write-protected by the caller
    nulling their table rows.  Returns (x, cache) with the same dict."""
    if "k_scale" in cache:
        raise NotImplementedError("paged prefill: int8 KV pools are not "
                                  "ported yet")
    b, t, _ = x.shape
    ps = cache["k"].shape[1]
    npp = block_table.shape[1]
    window = cfg.window if kind == ATTN_LOCAL else None
    pos = pos0.long()[:, None] + torch.arange(t, device=x.device)[None]
    h = L.rmsnorm(p["ln1"], x, cfg.norm_eps)
    q, k, v = L.qkv_project(p["attn"], h, cfg, pos)
    page, row = _paged_rows(block_table, pos, ps)
    cache["k"][page, row] = k.to(cache["k"].dtype)
    cache["v"][page, row] = v.to(cache["v"].dtype)
    bt = block_table.long()
    ka = cache["k"][bt].reshape(b, npp * ps, cfg.n_kv_heads, cfg.hd)
    va = cache["v"][bt].reshape(b, npp * ps, cfg.n_kv_heads, cfg.hd)
    o = L.mea_attention(q, ka, va, causal=True, window=window, q_pos=pos)
    o = o.reshape(b, t, -1) @ p["attn"]["wo"].to(x.dtype)
    return _ffn_out(p, x + o, cfg), cache
