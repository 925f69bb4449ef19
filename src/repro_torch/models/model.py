"""The decoder LM: init, the whole-sequence forward and the chunked loss of
training, and the caches, chunked prefill, decode step and speculative
verify step of serving.

Mirrors, from `repro/models/model.py`: `lm_init` (:105), `_embed` (:150),
`_run_stack` (:158-200), `lm_apply` (:202-230), `_head` (:293),
`lm_loss` (:299-343), `lm_init_cache` (:346), `lm_init_cache_paged`
(:376), `lm_decode_step` (:408), `lm_verify_step` (:462) and `lm_prefill`
(:586), each for the contiguous and the paged cache where the reference
has both.

Differences from the reference, all of layout and not of arithmetic:

* parameters are a plain dict of tensors with one dict per layer (the
  reference stacks layers of one pattern position on a leading axis and
  `lax.scan`s over it, which is what `_period` (:27) splits out); the scan
  becomes a Python loop over ``cfg.layer_kinds()``;
* a cache is ``{"layers": [{"k", "v"}, ...]}`` and `lm_prefill`,
  `lm_decode_step` and `lm_verify_step` write it IN PLACE (the reference
  returns a new cache); they still return the cache for symmetry;
* attention stacks (global and local layers) with dense-FFN or MoE
  layers are ported; recurrent, SSM and enc-dec models raise
  NotImplementedError, and so does MoE training (`lm_apply` / `lm_loss`).
"""
from __future__ import annotations

import functools
import math

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core.device import resolve_device
from repro_torch.models import blocks as B
from repro_torch.models import layers as L
from repro_torch.models.config import ATTN_GLOBAL, ATTN_LOCAL, ModelConfig

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}
LOSS_CHUNK = 512
REMATS = ("none", "full")


def _check_supported(cfg: ModelConfig) -> None:
    if cfg.is_encdec or any(
            k not in (ATTN_GLOBAL, ATTN_LOCAL) for k in cfg.layer_kinds()):
        raise NotImplementedError(f"{cfg.name}: only attention + FFN / MoE "
                                  f"decoders are ported yet")


def compute_dtype(cfg: ModelConfig) -> torch.dtype:
    return _DTYPES[cfg.compute_dtype]


def lm_init(cfg: ModelConfig, generator: torch.Generator | None = None,
            device=None, dtype: torch.dtype = torch.bfloat16) -> dict:
    """Random weights drawn with ``generator`` (seed it for repeatable
    weights; it must live on ``device``) in the reference's distributions:
    embedding N(0, 0.02^2), projections N(0, 1/d_in), RMSNorm scales 0;
    MoE layers (`repro/models/layers.py:674`): router and shared gate
    N(0, 1/d), experts (E_pad, d, F) / (E_pad, F, d) N(0, 1/d_in), the
    shared experts one SwiGLU of width n_shared * moe_d_ff.  Each tensor is
    drawn in float32 and cast at once, one at a time (a full-width
    qwen2-moe-a2.7b would not fit in float32).
    Matmul weights and the embedding in ``dtype`` (bf16 for serving;
    float32 master weights for training, the reference's layout,
    `layers.py:78-85`), norm scales float32.  Not meant to reproduce JAX's
    numbers (`interop.params_from_numpy` carries those across).  Runs on
    ``cuda`` unless ``device="cpu"``."""
    _check_supported(cfg)
    dev = resolve_device(device)

    def normal(shape, std):
        w = torch.randn(shape, generator=generator, device=dev,
                        dtype=torch.float32)
        return (w * std).to(dtype)

    def dense(d_in, d_out, std=None):
        return normal((d_in, d_out), std or 1.0 / math.sqrt(d_in))

    def swiglu(d_in, width):
        return {"w1": dense(d_in, width), "w3": dense(d_in, width),
                "w2": dense(width, d_in)}

    def moe_layer():
        e, ff = cfg.n_experts_padded, cfg.moe_d_ff
        p = {"router": dense(d, e),
             "w1": normal((e, d, ff), 1.0 / math.sqrt(d)),
             "w3": normal((e, d, ff), 1.0 / math.sqrt(d)),
             "w2": normal((e, ff, d), 1.0 / math.sqrt(ff))}
        if cfg.n_shared_experts:
            p["shared"] = swiglu(d, cfg.n_shared_experts * ff)
            p["shared_gate"] = dense(d, 1)
        return p

    def norm(d):
        return {"scale": torch.zeros(d, dtype=torch.float32, device=dev)}

    d, hd, nq, nkv = cfg.d_model, cfg.hd, cfg.n_heads, cfg.n_kv_heads
    params: dict = {"embed": normal((cfg.vocab_padded, d), 0.02),
                    "final_norm": norm(d)}
    if not cfg.tie_embeddings:
        params["lm_head"] = dense(d, cfg.vocab_padded)
    layers = []
    for _ in range(cfg.n_layers):
        attn = {"wq": dense(d, nq * hd), "wk": dense(d, nkv * hd),
                "wv": dense(d, nkv * hd), "wo": dense(nq * hd, d)}
        if cfg.qkv_bias:
            for n, w in (("bq", nq), ("bk", nkv), ("bv", nkv)):
                attn[n] = torch.zeros(w * hd, dtype=dtype, device=dev)
        if cfg.qk_norm:
            attn["qnorm"], attn["knorm"] = norm(hd), norm(hd)
        layer = {"ln1": norm(d), "attn": attn, "ln2": norm(d)}
        if cfg.n_experts:
            layer["moe"] = moe_layer()
        else:
            layer["ffn"] = swiglu(d, cfg.d_ff)
        layers.append(layer)
    params["layers"] = layers
    return params


def _embed(params, tokens, cfg: ModelConfig):
    return params["embed"][tokens.long()].to(compute_dtype(cfg))


def _head(params, cfg: ModelConfig):
    if cfg.tie_embeddings:
        return params["embed"].T
    return params["lm_head"]


def _logits(params, x, cfg: ModelConfig, step: bool = False):
    """Final norm + head on (..., d) rows -> float32 (..., vocab); a decode
    or verify ``step`` takes the step's product (a tied head read K-major
    in place) with the final norm as its prologue."""
    if L.step_kernel(cfg, step):
        logits = L.dense(x, _head(params, cfg), kernel=True,
                         norm=(params["final_norm"]["scale"],
                               cfg.norm_eps)).float()
    else:
        x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
        logits = L.dense(x, _head(params, cfg)).float()
    return logits[..., : cfg.vocab]               # drop pad-vocab ids


def _run_stack(params, x, cfg: ModelConfig, *, pos, remat: str = "none",
               pos_trivial: bool = False):
    """The layers in order (the reference's ``lax.scan`` over periods is a
    Python loop).  ``remat="full"`` checkpoints each layer, as
    ``jax.checkpoint(period_body)`` does for a period of one layer;
    ``"dots"`` (save the products) is not ported."""
    if remat == "dots":
        raise NotImplementedError("remat='dots' is not ported yet")
    if remat not in REMATS:
        raise ValueError(f"remat must be one of {REMATS}, got {remat!r}")
    for p, kind in zip(params["layers"], cfg.layer_kinds()):
        block = functools.partial(B.attn_block, cfg=cfg, kind=kind, pos=pos,
                                  pos_trivial=pos_trivial)
        x = (checkpoint(block, p, x, use_reentrant=False)
             if remat == "full" else block(p, x))
    return x


def lm_apply(params, batch, cfg: ModelConfig, *, remat: str = "none"):
    """batch {"tokens" (B,S) int[, "positions" (B,S)]} -> final hidden
    states (B,S,d) in the compute dtype.  Without explicit positions, row i
    is position i (``pos_trivial``), which is what lets the flash kernel's
    causal mask stand in for the positions; batches that carry positions
    keep the `mea_attention` path.  The reference's MoE auxiliary loss is
    0 for the dense stacks ported here and is not returned."""
    tokens = batch["tokens"]
    b, s = tokens.shape
    pos = batch.get("positions")
    pos_trivial = pos is None
    if pos is None:
        pos = torch.arange(s, device=tokens.device)[None].expand(b, s)
    x = _embed(params, tokens, cfg)
    x = _run_stack(params, x, cfg, pos=pos, remat=remat,
                   pos_trivial=pos_trivial)
    return L.rmsnorm(params["final_norm"], x, cfg.norm_eps)


def _ce_chunk(h, head, labels, mask, vmask):
    """Summed cross-entropy and token count of one (B, chunk) slice: pad
    vocab ids masked to -1e30, logits float32."""
    logits = (h @ head.to(h.dtype)).float()
    logits = torch.where(vmask, logits, torch.full_like(logits, -1e30))
    lse = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels.long()[..., None])[..., 0]
    return ((lse - gold) * mask).sum(), mask.sum()


def lm_loss(params, batch, cfg: ModelConfig, *, remat: str = "none"):
    """Chunked cross-entropy over ``LOSS_CHUNK`` positions at a time ->
    (loss, metrics).  Under autograd each chunk is checkpointed, as the
    reference's ``jax.checkpoint(ce_chunk)``: its (B, chunk, vocab) logits
    are recomputed in the backward instead of being kept (un-chunked, they
    would be B*S*vocab*4 bytes)."""
    hidden = lm_apply(params, batch, cfg, remat=remat)
    labels = batch["labels"]
    mask = batch.get("loss_mask")
    if mask is None:
        mask = torch.ones(labels.shape, dtype=torch.float32,
                          device=labels.device)
    b, s, _ = hidden.shape
    head = _head(params, cfg)
    chunk = min(LOSS_CHUNK, s)
    n = s // chunk if s % chunk == 0 else 1
    chunk = s // n
    vmask = torch.arange(head.shape[-1], device=hidden.device) < cfg.vocab
    grad = torch.is_grad_enabled() and hidden.requires_grad
    tot = cnt = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for i in range(n):
        sl = slice(i * chunk, (i + 1) * chunk)
        args = (hidden[:, sl], head, labels[:, sl], mask[:, sl].float(),
                vmask)
        t, c = (checkpoint(_ce_chunk, *args, use_reentrant=False) if grad
                else _ce_chunk(*args))
        tot, cnt = tot + t, cnt + c
    ce = tot / torch.clamp(cnt, min=1.0)
    return ce, {"ce": ce, "tokens": cnt}


def lm_init_cache(cfg: ModelConfig, b: int, s_max: int,
                  dtype=torch.bfloat16, device=None) -> dict:
    """Contiguous decode cache: a (b, s_max, Hkv, hd) K and V cache per
    attention layer (int8 with f32 (b, s_max, Hkv) scales under
    ``cfg.kv_quant="int8"``).  Runs on ``cuda`` unless ``device="cpu"``."""
    _check_supported(cfg)
    dev = resolve_device(device)
    return {"layers": [B.attn_cache_init(cfg, b, s_max, dtype, dev)
                       for _ in range(cfg.n_layers)]}


def lm_init_cache_paged(cfg: ModelConfig, num_pages: int, page_size: int,
                        dtype=torch.bfloat16, device=None) -> dict:
    """Paged decode cache: one global K and V pool (num_pages, page_size,
    Hkv, hd) per attention layer, all sharing ONE page-id space (page p is
    row p of every layer's pool); int8 pools with f32 scale pools under
    ``cfg.kv_quant="int8"``.  Slots reach their rows through their block
    table.  Runs on ``cuda`` unless ``device="cpu"``."""
    _check_supported(cfg)
    dev = resolve_device(device)
    return {"layers": [B.attn_cache_init_paged(cfg, num_pages, page_size,
                                               dtype, dev)
                       for _ in range(cfg.n_layers)]}


def lm_decode_step(params, cache, tokens, pos, cfg: ModelConfig, *,
                   block_table=None, write_mask=None):
    """tokens: (B,1) int; pos: (B,) int32 -> (logits (B, vocab) float32,
    cache).  Each layer writes its new K/V row into the cache in place.
    ``block_table`` (B,npp) int32 selects the paged layout; without it the
    cache is contiguous, and a slot at or past the cache length writes
    nothing.  ``write_mask`` (B,) bool (paged only) routes a slot's writes
    to the NULL page."""
    x = _embed(params, tokens, cfg)
    for p, c, kind in zip(params["layers"], cache["layers"],
                          cfg.layer_kinds()):
        if block_table is None:
            x, _ = B.attn_block_decode(p, x, cfg, c, kind=kind, pos=pos)
        else:
            x, _ = B.attn_block_decode_paged(p, x, cfg, c, kind=kind,
                                             pos=pos,
                                             block_table=block_table,
                                             write_mask=write_mask)
    return _logits(params, x[:, 0], cfg, step=True), cache


def lm_verify_step(params, cache, tokens, pos0, cfg: ModelConfig, *,
                   block_table, valid_len=None):
    """Score T drafted tokens per slot in one pass (speculative decoding).
    tokens: (B,T) int, token t at cache position ``pos0[b] + t``;
    block_table: (B,npp) int32 (paged cache only); valid_len: (B,) — rows
    ``t >= valid_len[b]`` are batch padding (their writes go to the NULL
    page, their logits are garbage).  Returns (logits (B,T,vocab) float32
    — row t scores position pos0+t+1 — and the cache, rows [pos0, pos0+T)
    written in place).  Row t equals what `lm_decode_step` at pos0+t
    computes from the same cache prefix: the exactness property the greedy
    accept rule builds on.  On the card under the kernel backends the two
    are bit-equal, and so are the cache rows each writes (paged decode is
    the verify attention at T = 1, and every product and norm of both
    steps is row-invariant, `layers.step_kernel`); on the plain paths
    they agree up to rounding."""
    x = _embed(params, tokens, cfg)
    for p, c, kind in zip(params["layers"], cache["layers"],
                          cfg.layer_kinds()):
        x, _ = B.attn_block_verify_paged(p, x, cfg, c, kind=kind, pos0=pos0,
                                         block_table=block_table,
                                         valid_len=valid_len)
    return _logits(params, x, cfg, step=True), cache


def lm_prefill(params, tokens, cfg: ModelConfig, *, cache, block_table=None,
               pos0=None, mask=None):
    """Chunked prefill: push a (B, T) token chunk through the stack, writing
    attention K/V rows [pos0, pos0+T) into the cache in place.  Call
    repeatedly with increasing ``pos0`` to ingest a long prompt in chunks;
    composes with `lm_decode_step`.

    ``block_table`` selects the paged layout, where the table is the write
    protection (the caller nulls the rows of slots not being prefilled) and
    ``mask`` is not used, as in the reference.  On the contiguous cache
    ``mask`` (B,) bool selects the slots whose rows are written (default
    all); the other slots' caches stay as they were.  Returns (last-token
    logits (B, vocab) float32, cache)."""
    b, t = tokens.shape
    if pos0 is None:
        pos0 = torch.zeros((b,), dtype=torch.int32, device=tokens.device)
    x = _embed(params, tokens, cfg)
    for p, c, kind in zip(params["layers"], cache["layers"],
                          cfg.layer_kinds()):
        if block_table is None:
            x, _ = B.attn_block_prefill(p, x, cfg, c, kind=kind, pos0=pos0,
                                        mask=mask)
        else:
            x, _ = B.attn_block_prefill_paged(p, x, cfg, c, kind=kind,
                                              pos0=pos0,
                                              block_table=block_table)
    return _logits(params, x[:, -1], cfg), cache
