"""The attention + (FFN | MoE) residual block: the whole-sequence block of
training and the serving paths' blocks (contiguous and paged caches, and
the speculative verify pass).

Mirrors, from `repro/models/blocks.py`:

* `attn_block` (:44-69) — one block over a whole sequence (training);
* `attn_cache_init` (:167) — a contiguous (B, S, Hkv, hd) K and V cache
  per layer (int8 plus (B, S, Hkv) f32 scales under
  ``cfg.kv_quant="int8"``);
* `attn_block_decode` (:72) / `attn_block_prefill` (:113) — one decode
  step / one prefill chunk of a block on the contiguous cache;
* `attn_cache_init_paged` (:185) — one global (P, page_size, Hkv, hd) K and
  V pool per layer (int8 pools plus (P, page_size, Hkv) f32 scale pools
  under ``cfg.kv_quant="int8"``);
* `_paged_rows` (:202) — physical (page, row) of logical cache rows;
* `attn_block_decode_paged` (:211) — one decode step of a block;
* `attn_block_prefill_paged` (:260) — one prefill chunk of a block;
* `attn_block_verify_paged` (:310) — T drafted rows of a block in one
  pass (speculative decoding).

The reference updates the caches functionally (``cache["k"].at[page,
row].set(...)`` returns a new pool).  Here every block function writes the
new K/V rows INTO the caches in place and returns the same dict, so a
serving step never copies a cache.  int8 caches are quantized on append
(`quantize_kv`, per row and kv head).

JAX drops a scatter to a row past the cache; PyTorch raises on the CPU
and faults on the card.  The contiguous blocks therefore write exactly the
rows the reference commits: rows below S, and in prefill only the slots
``mask`` selects (the reference writes every slot, then keeps the masked
ones' caches).  A row that must stay as it was gets its own old value
back, so the write stays one in-place scatter with no host sync.

The serving blocks run MoE layers (`layers.moe`, with the reference's
capacities); the whole-sequence training block does not yet (MoE training
is not ported) and raises for them.

The decode and verify blocks run their dense products and norms as a
step (`layers.step_kernel`): under a kernel ``ffn_backend`` on
row-invariant kernels, so a row's bits do not depend on the step's row
count; ln1 and a dense FFN's ln2 run as the prologue of the products that
read them.  Prefill and training keep theirs.
"""
from __future__ import annotations

import torch

from repro_torch.models import layers as L
from repro_torch.models.config import ATTN_LOCAL, ModelConfig
from repro_torch.quant.qtypes import asdense, dequantize_kv, quantize_kv


def attn_cache_init_paged(cfg: ModelConfig, num_pages: int, page_size: int,
                          dtype=torch.bfloat16, device=None):
    """Zeroed K and V pools, (num_pages, page_size, Hkv, hd) each, in
    ``dtype`` — or, under ``cfg.kv_quant="int8"``, int8 pools plus zeroed
    f32 ``k_scale`` / ``v_scale`` pools (num_pages, page_size, Hkv).  Page 0
    is the NULL page: never allocated; inactive slots' writes land there."""
    shape = (num_pages, page_size, cfg.n_kv_heads, cfg.hd)
    if cfg.kv_quant == "int8":
        return {"k": torch.zeros(shape, dtype=torch.int8, device=device),
                "v": torch.zeros(shape, dtype=torch.int8, device=device),
                "k_scale": torch.zeros(shape[:3], dtype=torch.float32,
                                       device=device),
                "v_scale": torch.zeros(shape[:3], dtype=torch.float32,
                                       device=device)}
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _write_rows(cache, page, row, k, v):
    """Scatter new K/V rows into the pools in place, quantizing them on
    append for int8 pools (`repro/models/blocks.py:232-240`, :271-281)."""
    if "k_scale" in cache:
        k, ks = quantize_kv(k.float())
        v, vs = quantize_kv(v.float())
        cache["k_scale"][page, row] = ks
        cache["v_scale"][page, row] = vs
    cache["k"][page, row] = k.to(cache["k"].dtype)
    cache["v"][page, row] = v.to(cache["v"].dtype)


def attn_cache_init(cfg: ModelConfig, b: int, s_max: int,
                    dtype=torch.bfloat16, device=None):
    """Zeroed contiguous K and V caches, (b, s_max, Hkv, hd) each, in
    ``dtype`` — or, under ``cfg.kv_quant="int8"``, int8 caches plus zeroed
    f32 ``k_scale`` / ``v_scale`` (b, s_max, Hkv)."""
    shape = (b, s_max, cfg.n_kv_heads, cfg.hd)
    if cfg.kv_quant == "int8":
        return {"k": torch.zeros(shape, dtype=torch.int8, device=device),
                "v": torch.zeros(shape, dtype=torch.int8, device=device),
                "k_scale": torch.zeros(shape[:3], dtype=torch.float32,
                                       device=device),
                "v_scale": torch.zeros(shape[:3], dtype=torch.float32,
                                       device=device)}
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _write_contig(cache, pos, k, v, write=None):
    """Write K/V rows (B,T,Hkv,hd) at cache rows ``pos`` (B,T) in place
    where ``write`` (broadcast to (B,T); default everywhere) holds and the
    row is below S, quantizing on append for int8 caches.  The T rows of a slot are distinct modulo S
    (T <= S), so every other row is sent to its own position modulo S and
    given back the value it had."""
    s = cache["k"].shape[1]
    idx = pos.long() % s
    keep = pos < s if write is None else write & (pos < s)
    bidx = torch.arange(pos.shape[0], device=pos.device)[:, None]
    new = {"k": k, "v": v}
    if "k_scale" in cache:
        (new["k"], new["k_scale"]), (new["v"], new["v_scale"]) = (
            quantize_kv(k.float()), quantize_kv(v.float()))
    for name, rows in new.items():
        leaf = cache[name]
        sel = keep.reshape(keep.shape + (1,) * (rows.dim() - 2))
        leaf[bidx, idx] = torch.where(sel, rows.to(leaf.dtype),
                                      leaf[bidx, idx])


def attn_block_decode(p, x, cfg: ModelConfig, cache, *, kind: str, pos):
    """One decode step on the contiguous cache.  x: (B,1,d); cache
    {'k','v'[,'k_scale','v_scale']} (B,S,kv,hd); pos: (B,).  The new K/V
    row is written in place (quantized on append for int8), except for a
    slot whose ``pos`` is at or past S (a finished slot riding along in a
    decode block), whose write the reference drops; attention dispatches
    through `layers.decode_attention` with the config's decode knobs.
    Returns (x, cache) with ``cache`` the same dict."""
    window = cfg.window if kind == ATTN_LOCAL else None
    kern = L.step_kernel(cfg, True)
    q, k, v = L.qkv_project(p["attn"], x, cfg, pos[:, None], step=True,
                            ln=p["ln1"])
    _write_contig(cache, pos[:, None], k, v)
    o = L.decode_attention(q, cache["k"], cache["v"], pos, window=window,
                           backend=cfg.decode_backend,
                           cfg=cfg.decode_attn_cfg, bkv=cfg.decode_bkv,
                           k_scale=cache.get("k_scale"),
                           v_scale=cache.get("v_scale"))
    x = x + L.dense(o.reshape(x.shape[0], 1, -1), p["attn"]["wo"],
                    kernel=kern)
    return _ffn_out(p, x, cfg, decode_moe_capacity(cfg, x.shape[0]),
                    step=True), cache


def attn_block_prefill(p, x, cfg: ModelConfig, cache, *, kind: str, pos0,
                       mask=None):
    """One prefill chunk on the contiguous cache.  x: (B,T,d); pos0: (B,)
    chunk start rows; mask: (B,) bool, the slots whose rows
    [pos0, pos0+T) are written (default all).  Attention runs against the
    whole cache with global row positions through `layers.flash_attention`,
    which takes `mea_attention` here, as in the reference: the chunk rows
    sit at ragged positions inside a padded cache.  int8 caches are
    quantized on append and dequantized (to x's dtype) for attention.  MoE
    layers run with capacity B*T.  Returns (x, cache)."""
    b, t, _ = x.shape
    window = cfg.window if kind == ATTN_LOCAL else None
    pos = pos0.long()[:, None] + torch.arange(t, device=x.device)[None]
    h = L.rmsnorm(p["ln1"], x, cfg.norm_eps)
    q, k, v = L.qkv_project(p["attn"], h, cfg, pos)
    _write_contig(cache, pos, k, v, None if mask is None else mask[:, None])
    ka, va = cache["k"], cache["v"]
    if "k_scale" in cache:
        ka = dequantize_kv(ka, cache["k_scale"]).to(x.dtype)
        va = dequantize_kv(va, cache["v_scale"]).to(x.dtype)
    o = L.flash_attention(q, ka, va, causal=True, window=window, q_pos=pos,
                          backend=cfg.attn_backend, cfg=cfg.attn_cfg,
                          bwd_cfg=cfg.attn_bwd_cfg, bq=cfg.attn_bq,
                          bkv=cfg.attn_bkv)
    o = o.reshape(b, t, -1) @ asdense(p["attn"]["wo"], x.dtype)
    return _ffn_out(p, x + o, cfg, moe_capacity=b * t), cache


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


def _ffn_out(p, x, cfg: ModelConfig, moe_capacity=None, step: bool = False):
    """x + FFN(ln2(x)); MoE layers with ``moe_capacity`` (the reference's
    decode and prefill capacities); a decode or verify ``step`` takes the
    step's norm and products: on `layers.step_kernel`'s route a dense
    FFN's ln2 is the gate and up products' prologue, an MoE layer's (read
    by the router, the experts and the shared expert) the row norm."""
    kern = L.step_kernel(cfg, step)
    if kern and not cfg.n_experts:
        return x + L.ffn(p["ffn"], x, backend=cfg.ffn_backend, step=True,
                         norm=(p["ln2"]["scale"], cfg.norm_eps))
    h = L.rmsnorm(p["ln2"], x, cfg.norm_eps, kernel=kern)
    if cfg.n_experts:
        y, _ = L.moe(p["moe"], h, cfg, capacity=moe_capacity, step=step)
        return x + y
    return x + L.ffn(p["ffn"], h, backend=cfg.ffn_backend, step=step)


def attn_block(p, x, cfg: ModelConfig, *, kind: str, pos,
               pos_trivial: bool = False):
    """One block over whole sequences.  x: (B,S,d); pos: (B,S) positions;
    ``pos_trivial`` says row i IS position i, which lets the flash kernel's
    causal mask stand in for the positions.  Attention dispatches through
    `layers.flash_attention` with the config's attn_* knobs; the FFN is
    dense (MoE raises: MoE training is not ported yet).  Returns x only:
    the reference's second output is the MoE auxiliary loss, 0 for dense
    blocks."""
    if cfg.n_experts:
        raise NotImplementedError("MoE training (the whole-sequence block "
                                  "and its auxiliary loss) is not ported "
                                  "yet")
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
    o = o.reshape(x.shape[0], x.shape[1], -1) @ asdense(p["attn"]["wo"],
                                                        x.dtype)
    return _ffn_out(p, x + o, cfg)


def attn_decode_paged(p, x, cfg: ModelConfig, cache, *, kind: str, pos,
                      block_table, write_mask=None):
    """The attention half of one decode step: x + attention(ln1(x)).  The
    new K/V row scatters through the table into the pools IN PLACE
    (quantized on append for int8 pools), then attention reads the pools
    through the same table.  ``write_mask`` (B,) bool routes a slot's write
    to the NULL page."""
    window = cfg.window if kind == ATTN_LOCAL else None
    ps = cache["k"].shape[1]
    kern = L.step_kernel(cfg, True)
    q, k, v = L.qkv_project(p["attn"], x, cfg, pos[:, None], step=True,
                            ln=p["ln1"])
    page, row = _paged_rows(block_table, pos, ps)
    if write_mask is not None:
        page = torch.where(write_mask, page, torch.zeros_like(page))
    _write_rows(cache, page, row, k[:, 0], v[:, 0])
    o = L.paged_decode_attention(q, cache["k"], cache["v"], block_table, pos,
                                 window=window, backend=cfg.decode_backend,
                                 cfg=cfg.decode_attn_cfg,
                                 k_scale=cache.get("k_scale"),
                                 v_scale=cache.get("v_scale"))
    return x + L.dense(o.reshape(x.shape[0], 1, -1), p["attn"]["wo"],
                       kernel=kern)


def decode_moe_capacity(cfg: ModelConfig, b: int) -> int:
    """MoE capacity of a decode step of ``b`` slots (the reference's
    max(4, min(B, 4 * top_k)), `repro/models/blocks.py:250`)."""
    return max(4, min(b, 4 * cfg.top_k))


def attn_block_decode_paged(p, x, cfg: ModelConfig, cache, *, kind: str, pos,
                            block_table, write_mask=None):
    """One decode step.  x: (B,1,d); cache {'k','v'[,'k_scale','v_scale']}
    pools (P,ps,kv,hd); block_table (B,npp) int32; pos (B,).  The attention
    half (`attn_decode_paged`) writes the new K/V row in place; MoE layers
    then run with `decode_moe_capacity`.  Returns (x, cache) with
    ``cache`` the same dict."""
    x = attn_decode_paged(p, x, cfg, cache, kind=kind, pos=pos,
                          block_table=block_table, write_mask=write_mask)
    return _ffn_out(p, x, cfg, decode_moe_capacity(cfg, x.shape[0]),
                    step=True), cache


def attn_block_prefill_paged(p, x, cfg: ModelConfig, cache, *, kind: str,
                             pos0, block_table):
    """One prefill chunk.  x: (B,T,d); pos0: (B,) chunk start rows.  The
    chunk's K/V rows scatter through the table into the pools IN PLACE;
    attention gathers each slot's logical view back out of the pools and
    runs the chunked plain attention (the reference has no prefill kernel
    on this path).  Non-admitted slots are write-protected by the caller
    nulling their table rows.  int8 pools are quantized on append and the
    gathered view is dequantized (to x's dtype) before attention.  MoE
    layers run with capacity B*T, as the reference.  Returns (x, cache)
    with the same dict."""
    b, t, _ = x.shape
    ps = cache["k"].shape[1]
    npp = block_table.shape[1]
    window = cfg.window if kind == ATTN_LOCAL else None
    pos = pos0.long()[:, None] + torch.arange(t, device=x.device)[None]
    h = L.rmsnorm(p["ln1"], x, cfg.norm_eps)
    q, k, v = L.qkv_project(p["attn"], h, cfg, pos)
    page, row = _paged_rows(block_table, pos, ps)
    _write_rows(cache, page, row, k, v)
    bt = block_table.long()
    ka = cache["k"][bt].reshape(b, npp * ps, cfg.n_kv_heads, cfg.hd)
    va = cache["v"][bt].reshape(b, npp * ps, cfg.n_kv_heads, cfg.hd)
    if "k_scale" in cache:
        ka = dequantize_kv(ka, cache["k_scale"][bt].reshape(b, npp * ps, -1)
                           ).to(x.dtype)
        va = dequantize_kv(va, cache["v_scale"][bt].reshape(b, npp * ps, -1)
                           ).to(x.dtype)
    o = L.mea_attention(q, ka, va, causal=True, window=window, q_pos=pos)
    o = o.reshape(b, t, -1) @ asdense(p["attn"]["wo"], x.dtype)
    return _ffn_out(p, x + o, cfg, moe_capacity=b * t), cache


def attn_block_verify_paged(p, x, cfg: ModelConfig, cache, *, kind: str,
                            pos0, block_table, valid_len=None):
    """T drafted rows per slot in one pass (speculative decoding).  x:
    (B,T,d); pos0: (B,); row t sits at ``pos0 + t``.  The rows scatter
    through the table into the pools in place (quantized on append for
    int8); ``valid_len`` (B,) marks rows ``t >= valid_len[b]`` as batch
    padding, whose writes are routed to the NULL page (past the slot's
    pages the clamped lookup would alias a live page).  Attention scores
    all rows in one short-q pass (`layers.verify_attention`); MoE layers
    run with capacity B*T.  Returns (x, cache) with the same dict."""
    b, t, _ = x.shape
    ps = cache["k"].shape[1]
    window = cfg.window if kind == ATTN_LOCAL else None
    pos = pos0.long()[:, None] + torch.arange(t, device=x.device)[None]
    kern = L.step_kernel(cfg, True)
    q, k, v = L.qkv_project(p["attn"], x, cfg, pos, step=True, ln=p["ln1"])
    page, row = _paged_rows(block_table, pos, ps)
    if valid_len is not None:
        live = torch.arange(t, device=x.device)[None] < valid_len[:, None]
        page = torch.where(live, page, torch.zeros_like(page))
    _write_rows(cache, page, row, k, v)
    o = L.verify_attention(q, cache["k"], cache["v"], block_table, pos0,
                           window=window, backend=cfg.decode_backend,
                           cfg=cfg.decode_attn_cfg,
                           k_scale=cache.get("k_scale"),
                           v_scale=cache.get("v_scale"))
    o = L.dense(o.reshape(b, t, -1), p["attn"]["wo"], kernel=kern)
    return _ffn_out(p, x + o, cfg, moe_capacity=b * t, step=True), cache
