"""Model building blocks: RMSNorm, RoPE, the GQA q/k/v projection, chunked
memory-efficient attention, the training/prefill flash-attention dispatch,
decode attention (contiguous and paged dispatch, bf16 or int8 caches),
speculative verify attention (paged dispatch), the SwiGLU
FFN (dense or quantized weights) and the top-k MoE layer.

Mirrors `repro.models.layers` function for function, on PyTorch tensors.
``backend`` values: ``"ref"`` takes the plain path, ``"cuda"`` the port's
hand-written kernel (on CPU tensors, that kernel's plain version).
Weights are cast to the activations' dtype where they are used, as the
reference's ``asdense(w, x.dtype)`` does, so float32 master weights train
with bf16 compute; quantized (`QTensor`) weights are dequantized there by
the same `asdense`, except where a dequant-fused kernel takes them.

The decode and verify steps of serving (``step=True``; `rmsnorm` and
`dense` take `step_kernel`'s answer as ``kernel``) run every dense
product and every norm under a kernel ``ffn_backend`` on row-invariant
kernels: the coarsened matmul at base under a K split planned for one
64-row tile (`dense`) and the row RMSNorm (`rmsnorm`).  A row's bits then do
not depend on how many rows the step holds, so row t of a verify pass
equals the decode step at the same position (SiLU*up is elementwise).
The norms that a product reads (ln1, a dense FFN's ln2, the final norm)
run as that product's prologue (`dense` with ``norm``), and the q/k norms
with RoPE as one rows kernel (`qkv_project`); an MoE layer's ln2 keeps
the row norm.  Prefill and training keep their products and norms.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.core.coarsening import BASE
from repro_torch.kernels import decode_attention as _decode
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import matmul as _matmul
from repro_torch.kernels import ops, ref
from repro_torch.kernels import rmsnorm as _norm
from repro_torch.kernels import sparse_attention as _sparse
from repro_torch.models.config import ModelConfig
from repro_torch.quant.qtypes import QTensor, asdense, dequantize_kv

NEG = -1e30
BACKENDS = ("ref", "cuda")

# Dispatches of CPU tensors sent to the plain path because the port's
# kernel does not hold a geometry that the reference's kernel takes (the
# `*_kernel_takes` rules below), counted per call: flash and block-sparse
# flash head dims other than 64 / 128 / 256 (or programs past 128 rows at
# 256), verify and contiguous decode with T*G > 64 query rows a kv head
# (or a head dim past 256), paged decode with G > 64 (the same rule at T =
# 1).  On the card such a geometry raises NotImplementedError
# (`_not_held`): the plain path never stands in for a kernel there.
flash_plain_routes = 0
sparse_plain_routes = 0
decode_plain_routes = 0
paged_plain_routes = 0
verify_plain_routes = 0


def _not_held(x: torch.Tensor, what: str) -> None:
    """Raise on a device tensor whose geometry the port's kernel does
    not hold yet; a CPU tensor goes on to the plain path."""
    if x.device.type != "cpu":
        raise NotImplementedError(
            f"{what}: the port's kernel does not hold this geometry yet")


def flash_kernel_takes(d: int, bq: int, bkv: int, cfg, bwd_cfg) -> bool:
    """Whether the flash kernels hold head dim ``d`` with programs of
    ``cfg`` x ``bq`` q rows (forward, dQ) and ``bwd_cfg`` x ``bkv`` kv
    rows (dK/dV)."""
    return (_flash.takes(d, cfg.degree, bq, bkv, kv_axis=False)
            and _flash.takes(d, bwd_cfg.degree, bq, bkv, kv_axis=True))


def sparse_kernel_takes(d: int, bq: int, bkv: int, cfg, bwd_cfg) -> bool:
    """Whether the block-sparse forward holds head dim ``d`` with q blocks
    of ``bq`` rows (``cfg`` is a live-slot degree, which any geometry
    holds once it divides max_live) and its backward the dense dQ at
    `BASE` and dK/dV at ``bwd_cfg``."""
    del cfg
    return (_sparse.takes(d, bq, bkv)
            and flash_kernel_takes(d, bq, bkv, BASE, bwd_cfg))


def rows_kernel_takes(t: int, h: int, hkv: int, d: int, seg: int,
                      elem: int) -> bool:
    """Whether the rows kernel (paged and contiguous decode at T = 1,
    verify at T rows) holds T*G query rows a kv head over kv segments (pages
    or kv blocks) of ``seg`` rows."""
    return _decode.rows_takes(t, h // hkv, d, seg, elem)


def _uses_kernel(backend: str) -> bool:
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got "
                         f"{backend!r}")
    return backend == "cuda"


def step_kernel(cfg: ModelConfig, step: bool) -> bool:
    """Whether a block's dense products and norms take the row-invariant
    kernels: on a decode or verify ``step`` under a kernel
    ``ffn_backend``, which then also selects the attention projections,
    the norms and the head; never in training and prefill.  The one place
    the steps' route is decided: `rmsnorm` and `dense` take its answer."""
    return step and _uses_kernel(cfg.ffn_backend)


def rmsnorm(p, x, eps=1e-6, *, kernel: bool = False):
    """`repro/models/layers.py:87`: float32 statistics, scale applied as
    (1 + scale), result in x's dtype.  With ``kernel`` (a step's,
    `step_kernel`) the row kernel (`kernels.rmsnorm`), which sums every
    row in one order whatever the row count."""
    if kernel:
        return _norm.rmsnorm(x, p["scale"], eps)
    return ref.rmsnorm(x, p["scale"], eps)


def dense(x, w, *, kernel: bool = False, norm=None):
    """x (..., k) @ w (k, n) in x's dtype (`asdense(w, x.dtype)`, as the
    reference).  With ``kernel`` (a step's, `step_kernel`) the coarsened
    matmul kernel at base under its one-tile K split (`matmul.step_matmul`;
    on CPU tensors the plain float32 product), the float32 sums rounded
    to x's dtype on the store as the reference's product rounds them;
    ``w`` may then be K-major (a tied embedding's transpose).  ``norm`` =
    (scale, eps), ``kernel`` only: rmsnorm(x) @ w in the same launch, the
    row statistic and the scale applied in the kernel's prologue, bit for
    bit the row norm kernel's output multiplied."""
    w = asdense(w, x.dtype)
    if not kernel:
        if norm is not None:
            raise ValueError("dense: a norm prologue is the steps' route's "
                             "(kernel=True) only")
        return x @ w
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        raise RuntimeError("the steps' products have no backward: the "
                           "decode and verify steps run without autograd")
    k, n = w.shape
    y = _matmul.step_matmul(x.reshape(-1, k).contiguous(), w,
                            out_dtype=x.dtype, norm=norm)
    return y.view(*x.shape[:-1], n)


def apply_rope(x: torch.Tensor, pos: torch.Tensor, theta: float):
    """x: (B,S,H,D); pos: (B,S) int.  Interleaved pairs (x[..., ::2],
    x[..., 1::2]) rotated in float32, as the reference (`ref.rope`)."""
    return ref.rope(x, pos, ref.rope_freqs(x.shape[-1], theta, x.device))


def qkv_project(p, x, cfg: ModelConfig, pos, *, step: bool = False,
                ln=None):
    """x: (B,S,d) -> q (B,S,H,hd), k, v (B,S,Hkv,hd) with qk-norm and RoPE;
    a decode or verify ``step`` takes `step_kernel`'s products and
    norms.  ``ln`` (a step's, with the un-normed x): the block's ln1
    parameters, applied first; on `step_kernel`'s route each of the q, k
    and v products takes it as its prologue, and the q/k norms and RoPE
    run in one launch (`kernels.rmsnorm.qk_norm_rope`)."""
    if cfg.mrope_sections is not None:
        raise NotImplementedError("M-RoPE (qwen2-vl) is not ported yet")
    b, s, _ = x.shape
    hd, nq, nkv = cfg.hd, cfg.n_heads, cfg.n_kv_heads
    kern = step_kernel(cfg, step)
    norm = None
    if ln is not None:
        if kern:
            norm = (ln["scale"], cfg.norm_eps)
        else:
            x = rmsnorm(ln, x, cfg.norm_eps)
    q = dense(x, p["wq"], kernel=kern, norm=norm)
    k = dense(x, p["wk"], kernel=kern, norm=norm)
    v = dense(x, p["wv"], kernel=kern, norm=norm)
    if cfg.qkv_bias:
        q = q + p["bq"].to(x.dtype)
        k = k + p["bk"].to(x.dtype)
        v = v + p["bv"].to(x.dtype)
    q = q.reshape(b, s, nq, hd)
    k = k.reshape(b, s, nkv, hd)
    v = v.reshape(b, s, nkv, hd)
    if kern:
        qs, ks = ((p["qnorm"]["scale"], p["knorm"]["scale"]) if cfg.qk_norm
                  else (None, None))
        q, k = _norm.qk_norm_rope(q, k, pos, qs, ks, cfg.norm_eps,
                                  cfg.rope_theta)
        return q, k, v
    if cfg.qk_norm:
        q = rmsnorm(p["qnorm"], q, cfg.norm_eps)
        k = rmsnorm(p["knorm"], k, cfg.norm_eps)
    return apply_rope(q, pos, cfg.rope_theta), apply_rope(k, pos,
                                                          cfg.rope_theta), v


def mea_attention(q, k, v, *, causal=True, window=None, q_pos=None,
                  k_len=None, kv_chunk=512, scale=None):
    """Chunked (flash-style) attention, `repro/models/layers.py:185`.

    q: (B,Sq,H,D); k, v: (B,Sk,Hkv,D).  q_pos: (B,Sq) global row positions
    (default arange); k_len: valid kv length, an int or (B,) tensor (rows
    at and past it are masked).  K/V stay in their storage dtype; q is
    scaled in its own dtype; scores and the running (m, l, acc) are
    float32, and the probabilities are cast to V's dtype before the PV
    product — the reference's rounding points.  Under autograd each kv
    chunk is checkpointed, as the reference's ``jax.checkpoint`` on
    ``kv_step`` (:237-243): only the (m, l, acc) carry is saved and the
    chunk's scores are recomputed in the backward.
    """
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    dev = q.device
    if q_pos is None:
        q_pos = torch.arange(sq, device=dev)[None].expand(b, sq)
    q_pos = q_pos.to(torch.int64)
    qg = (q.reshape(b, sq, hkv, g, d) * torch.tensor(scale, dtype=q.dtype)
          ).float()
    kpos = torch.arange(sk, device=dev)
    valid = torch.ones((b, sk), dtype=torch.bool, device=dev)
    if k_len is not None:
        kl = torch.as_tensor(k_len, device=dev)
        valid = kpos[None, :] < (kl[:, None] if kl.dim() else kl)
        valid = valid.expand(b, sk)

    def kv_step(m, l, acc, kb, vb, kp, vk):
        s = torch.einsum("bqhgd,bkhd->bqhgk", qg, kb.float())
        mask = vk[:, None, :]                                   # (B,1,k)
        if causal:
            mask = mask & (kp[None, None, :] <= q_pos[:, :, None])
        if window is not None:
            mask = mask & (kp[None, None, :] > q_pos[:, :, None] - window)
        mask = mask[:, :, None, None, :]                        # (B,q,1,1,k)
        s = torch.where(mask, s, torch.full_like(s, NEG))
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None]) * mask
        alpha = torch.exp(m - m_new)
        l_new = l * alpha + p.sum(dim=-1)
        acc_new = acc * alpha[..., None] + torch.einsum(
            "bqhgk,bkhd->bqhgd", p.to(vb.dtype).float(), vb.float())
        return m_new, l_new, acc_new

    grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in (q, k, v))
    m = torch.full((b, sq, hkv, g), NEG, dtype=torch.float32, device=dev)
    l = torch.zeros((b, sq, hkv, g), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, sq, hkv, g, d), dtype=torch.float32, device=dev)
    for k0 in range(0, sk, kv_chunk):
        args = (m, l, acc, k[:, k0:k0 + kv_chunk], v[:, k0:k0 + kv_chunk],
                kpos[k0:k0 + kv_chunk], valid[:, k0:k0 + kv_chunk])
        m, l, acc = (checkpoint(kv_step, *args, use_reentrant=False)
                     if grad else kv_step(*args))
    l = torch.where(l == 0.0, torch.ones_like(l), l)
    out = (acc / l[..., None]).reshape(b, sq, h, d)
    return out.to(q.dtype)


def flash_attention(q, k, v, *, causal=True, window=None, q_pos=None,
                    k_len=None, pos_trivial=False, scale=None,
                    backend: str = "ref", cfg="auto", bwd_cfg="auto",
                    bq: int = 128, bkv: int = 128, global_stride=None,
                    sparse: str = "auto", sparse_cfg="auto"):
    """Training/prefill attention dispatch (`repro/models/layers.py:282`).
    q: (B,Sq,H,D); k, v: (B,Sk,Hkv,D) -> (B,Sq,H,D) in q's dtype.

    ``backend="cuda"`` takes the differentiable flash kernels
    (`ops.flash_attention`) under the reference's eligibility rule: no
    ``k_len``; ``h % hkv == 0``; Sq and Sk tile by bq / bkv (each capped at
    the sequence) and by the resolved degrees; causal or window masking
    needs Sq == Sk and ``pos_trivial`` (q row i IS global row i).
    Everything else takes `mea_attention`, as in the reference.  A
    geometry the port's kernels do not hold (`flash_kernel_takes`: head
    dims 64, 128 and 256, programs of 64-256 rows, up to 128 at 256)
    raises NotImplementedError on the card and takes `mea_attention` on
    CPU tensors, counted in ``flash_plain_routes``.

    A causal ``window`` under that rule with ``sparse != "off"`` takes the
    block-sparse kernel (`ops.flash_attention_sparse`, :323-346): each q
    block walks only the kv blocks its live index lists; ``sparse_cfg``
    coarsens over the live-slot axis ("auto" through the
    ``flash_attention_sparse`` family), and an explicit degree that does
    not divide the index width falls through to the dense path, as in the
    reference.  Every "auto" here resolves through `ops.resolve_cfg` under
    the reference's key before the port's rules apply; the dK/dV family
    only where a backward will run.  A geometry `sparse_kernel_takes` does not
    hold raises on the card and takes the dense-mask oracle on CPU
    tensors, counted in ``sparse_plain_routes``.  ``global_stride`` adds
    LongFormer-style global columns to a window; where the sparse kernel
    does not take such a pattern it takes the dense-mask oracle
    (:348-360), since neither the dense kernel nor `mea_attention` can
    express the strided columns.
    """
    global flash_plain_routes, sparse_plain_routes
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    kernel = _uses_kernel(backend)
    grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in (q, k, v))

    def bhsd(x):
        return x.transpose(1, 2).contiguous()

    # the ops' key builders read shapes off (B,H,S,D) views
    qv, kv = q.transpose(1, 2), k.transpose(1, 2)

    def resolved_bwd(blk_q, blk_k):
        # resolved only where a backward will run, as the reference's VJP
        # rule does: a forward-only call files no flash_attention_bwd key
        if grad or bwd_cfg != "auto":
            return ops.resolve_flash(bwd_cfg, qv, kv, bq=blk_q, bkv=blk_k,
                                     causal=causal, bwd=True)
        return BASE

    if (kernel and sparse != "off" and k_len is None and causal
            and window is not None and sq == sk and pos_trivial
            and h % hkv == 0):
        blk_q, blk_k = min(bq, sq), min(bkv, sk)
        if sq % blk_q == 0 and sk % blk_k == 0:
            ml, _ = ops.sparse_extent(sq, sk, blk_q, blk_k, True, window,
                                      global_stride)
            rsp = ops.resolve_flash_sparse(
                sparse_cfg, qv, kv, bq=blk_q, bkv=blk_k, causal=True,
                window=window, global_stride=global_stride)
            rbwd = BASE if global_stride else resolved_bwd(blk_q, blk_k)
            # an explicit slot degree the padded index can't tile falls
            # through to the dense path (a tuned one always fits)
            if ml % rsp.degree == 0:
                kw = dict(bq=blk_q, bkv=blk_k, causal=True, window=window,
                          global_stride=global_stride, scale=scale)
                if sparse_kernel_takes(d, blk_q, blk_k, rsp, rbwd):
                    o = ops.flash_attention_sparse(
                        bhsd(q), bhsd(k), bhsd(v), rsp, bwd_cfg=rbwd, **kw)
                else:
                    _not_held(q, f"block-sparse flash attention at head dim "
                              f"{d}, q blocks of {blk_q} rows, dK/dV "
                              f"programs of {rbwd.degree}x{blk_k} rows")
                    sparse_plain_routes += 1
                    o = ops.flash_attention_sparse(bhsd(q), bhsd(k), bhsd(v),
                                                   backend="ref", **kw)
                return o.transpose(1, 2).to(q.dtype)
    if (global_stride and window is not None and k_len is None
            and sq == sk and (pos_trivial or q_pos is None)):
        # the strided global columns exist in no other path's mask: the
        # dense-mask oracle (dense cost, exact semantics)
        o = ops.flash_attention_sparse(
            bhsd(q), bhsd(k), bhsd(v), backend="ref", causal=causal,
            window=window, global_stride=global_stride, scale=scale)
        return o.transpose(1, 2).to(q.dtype)
    if kernel and k_len is None:
        blk_q, blk_k = min(bq, sq), min(bkv, sk)
        ok = h % hkv == 0 and sq % blk_q == 0 and sk % blk_k == 0
        if causal or window is not None:
            ok = ok and sq == sk and pos_trivial
        if ok:
            rcfg = ops.resolve_flash(cfg, qv, kv, bq=blk_q, bkv=blk_k,
                                     causal=causal)
            rbwd = resolved_bwd(blk_q, blk_k)
            tiles = sq % (blk_q * rcfg.degree) == 0 \
                and sk % (blk_k * rbwd.degree) == 0
            if tiles and not flash_kernel_takes(d, blk_q, blk_k, rcfg, rbwd):
                _not_held(q, f"flash attention at head dim {d}, programs of "
                          f"{rcfg.degree}x{blk_q} / {rbwd.degree}x{blk_k} "
                          "rows")
                flash_plain_routes += 1
            elif tiles:
                o = ops.flash_attention(
                    bhsd(q), bhsd(k), bhsd(v), rcfg, bwd_cfg=rbwd,
                    bq=blk_q, bkv=blk_k, causal=causal, window=window,
                    scale=scale)
                return o.transpose(1, 2).to(q.dtype)
    return mea_attention(q, k, v, causal=causal, window=window, q_pos=q_pos,
                         k_len=k_len, scale=scale)


def decode_attention(q, k_cache, v_cache, pos, *, window=None, scale=None,
                     backend: str = "ref", cfg="auto", bkv: int = 128,
                     k_scale=None, v_scale=None):
    """Single-token attention against a contiguous cache
    (`repro/models/layers.py:397-456`).  q: (B,1,H,D); caches
    (B,S,Hkv,D); pos: (B,).  A kernel backend dispatches the contiguous
    split-KV kernel (kv blocks of min(bkv, S) rows) when ``h % hkv == 0``
    and S tiles by the block and by block * degree (a geometry the kernel
    does not hold, `rows_kernel_takes`, raises NotImplementedError on the
    card and takes the dense path on CPU tensors, counted in
    ``decode_plain_routes``); everything else takes the dense path: q is
    scaled and cast to the cache dtype, scores are float32, probabilities
    are cast to V's dtype before the PV product.
    ``k_scale`` / ``v_scale`` (B,S,Hkv) mark an int8 cache: the kernel
    takes it as it is; the dense path dequantizes it to float32 first."""
    global decode_plain_routes
    b, _, h, d = q.shape
    s, hkv = k_cache.shape[1], k_cache.shape[2]
    if _uses_kernel(backend):
        blk = min(bkv, s)
        if h % hkv == 0 and s % blk == 0:
            rcfg = ops.resolve_decode(cfg, q, k_cache, bkv=blk,
                                      window=window, k_scale=k_scale)
            if s % (blk * rcfg.degree) == 0 and not rows_kernel_takes(
                    1, h, hkv, d, blk, k_cache.element_size()):
                _not_held(q, f"contiguous decode with G={h // hkv} query "
                          f"heads a kv head at head dim {d}")
                decode_plain_routes += 1
            elif s % (blk * rcfg.degree) == 0:
                return ops.decode_attention(q, k_cache, v_cache, pos, rcfg,
                                            bkv=blk, window=window,
                                            scale=scale, k_scale=k_scale,
                                            v_scale=v_scale)
    if k_scale is not None:
        k_cache = dequantize_kv(k_cache, k_scale)
        v_cache = dequantize_kv(v_cache, v_scale)
    g = h // hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    qg = (q.reshape(b, hkv, g, d) * torch.tensor(scale, dtype=q.dtype)
          ).to(k_cache.dtype)
    logits = torch.einsum("bhgd,bshd->bhgs", qg.float(), k_cache.float())
    kpos = torch.arange(s, device=q.device)
    pos = pos.to(torch.int64)
    mask = kpos[None, :] <= pos[:, None]
    if window is not None:
        mask = mask & (kpos[None, :] > pos[:, None] - window)
    logits = torch.where(mask[:, None, None, :], logits,
                         torch.full_like(logits, NEG))
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgs,bshd->bhgd", p.to(v_cache.dtype).float(),
                       v_cache.float())
    return out.reshape(b, 1, h, d).to(q.dtype)


def paged_decode_attention(q, k_pool, v_pool, block_table, pos, *,
                           window=None, scale=None, backend: str = "ref",
                           cfg="auto", k_scale=None, v_scale=None):
    """Single-token attention against a PAGED cache
    (`repro/models/layers.py:457-504`).  A kernel backend dispatches the
    rows kernel at T = 1 (`ops.paged_decode_attention`: verify's call with
    ``pos0 = pos``, so a decode row and a verify row at the same position
    get the same bits) when the per-slot page count tiles by the
    coarsening degree, resolved under the paged family's key (a geometry
    the kernel does not hold, `rows_kernel_takes` at T = 1: G > 64,
    raises NotImplementedError on the card and takes the plain path on CPU
    tensors, counted in ``paged_plain_routes``); everything else gathers
    the table into contiguous per-slot views and takes the dense plain
    path.  ``k_scale`` / ``v_scale`` (P,ps,Hkv) mark int8 pools: the kernel
    takes them as they are; the plain path dequantizes the gathered views
    to float32 first."""
    global paged_plain_routes
    h, d = q.shape[2], q.shape[3]
    ps, hkv = k_pool.shape[1], k_pool.shape[2]
    npp = block_table.shape[1]
    if _uses_kernel(backend) and h % hkv == 0:
        rcfg = ops.resolve_paged(cfg, q, k_pool, block_table,
                                 window=window, k_scale=k_scale)
        if npp % rcfg.degree == 0 and not rows_kernel_takes(
                1, h, hkv, d, ps, k_pool.element_size()):
            _not_held(q, f"paged decode with G={h // hkv} query heads a kv "
                      f"head at head dim {d}")
            paged_plain_routes += 1
        elif npp % rcfg.degree == 0:
            return ops.paged_decode_attention(q, k_pool, v_pool, block_table,
                                              pos, rcfg, window=window,
                                              scale=scale, k_scale=k_scale,
                                              v_scale=v_scale)
    k_view = ref.gather_pages(k_pool, block_table)
    v_view = ref.gather_pages(v_pool, block_table)
    if k_scale is not None:
        k_view = dequantize_kv(k_view, ref.gather_scales(k_scale,
                                                         block_table))
        v_view = dequantize_kv(v_view, ref.gather_scales(v_scale,
                                                         block_table))
    return decode_attention(q, k_view, v_view, pos, window=window,
                            scale=scale)


def verify_attention(q, k_pool, v_pool, block_table, pos0, *, window=None,
                     scale=None, backend: str = "ref", cfg="auto",
                     k_scale=None, v_scale=None):
    """Batched-verify attention against a PAGED cache
    (`repro/models/layers.py:505-566`).  q: (B,T,H,D), row t at cache
    position ``pos0[b] + t``; pools, block_table and scales as in
    `paged_decode_attention`.  A kernel backend dispatches the short-q
    verify kernel when the per-slot page count tiles by the degree (more
    than 64 query rows T*G a kv head, `rows_kernel_takes`, raise
    NotImplementedError on the card and take the plain path on CPU
    tensors, counted in ``verify_plain_routes``); the plain path gathers the table into contiguous views and runs the decode
    dense contraction with one more row axis, row for row what
    `decode_attention` computes at ``pos0 + t``."""
    global verify_plain_routes
    b, t, h, d = q.shape
    _, ps, hkv, _ = k_pool.shape
    npp = block_table.shape[1]
    if _uses_kernel(backend) and h % hkv == 0:
        rcfg = ops.resolve_verify(cfg, q, k_pool, block_table,
                                  window=window, k_scale=k_scale)
        if npp % rcfg.degree == 0 and not rows_kernel_takes(
                t, h, hkv, d, ps, k_pool.element_size()):
            _not_held(q, f"verify with T*G={t * (h // hkv)} query rows a kv "
                      f"head at head dim {d}")
            verify_plain_routes += 1
        elif npp % rcfg.degree == 0:
            return ops.flash_attention_verify(
                q, k_pool, v_pool, block_table, pos0, rcfg, window=window,
                scale=scale, k_scale=k_scale, v_scale=v_scale)
    k_view = ref.gather_pages(k_pool, block_table)
    v_view = ref.gather_pages(v_pool, block_table)
    if k_scale is not None:
        k_view = dequantize_kv(k_view, ref.gather_scales(k_scale,
                                                         block_table))
        v_view = dequantize_kv(v_view, ref.gather_scales(v_scale,
                                                         block_table))
    s, g = npp * ps, h // hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    qg = (q.reshape(b, t, hkv, g, d) * torch.tensor(scale, dtype=q.dtype)
          ).to(k_view.dtype)
    logits = torch.einsum("bthgd,bshd->bthgs", qg.float(), k_view.float())
    kpos = torch.arange(s, device=q.device)
    rows = pos0.to(torch.int64)[:, None] + torch.arange(t, device=q.device)
    mask = kpos[None, None, :] <= rows[:, :, None]             # (B,T,S)
    if window is not None:
        mask = mask & (kpos[None, None, :] > rows[:, :, None] - window)
    logits = torch.where(mask[:, :, None, None, :], logits,
                         torch.full_like(logits, NEG))
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bthgs,bshd->bthgd", p.to(v_view.dtype).float(),
                       v_view.float())
    return out.reshape(b, t, h, d).to(q.dtype)


def ffn(p, x, *, backend: str = "ref", cfg="auto", step: bool = False,
        norm=None):
    """SwiGLU FFN (`repro/models/layers.py:631`).  With a kernel backend the
    gate, up and down products take the coarsened matmul kernel whenever
    the rows tile as the reference requires (T % 128, d % 256, d_ff % 256);
    otherwise they are the plain float32 product.  Each product resolves
    ``cfg`` under its own (m, n, k) key (`ops.matmul`, as the reference's
    `ops.matmul` does per call), so "auto" takes the tuned label of that
    product; an explicit ``cfg`` the kernel cannot tile raises, as the
    reference's kernel builder does.  Each product is cast back to x's
    dtype, as the reference.

    Quantized weights (`QTensor`) take the dequant-fused kernel
    (`ops.quant_matmul`) on the same rule plus ``256 % group`` (:646-653);
    everything else dequantizes densely (`asdense`) and continues as
    above, the reference's fallback.

    A decode or verify ``step`` under a kernel backend takes the steps'
    products (`dense` with ``kernel``) for all three whatever the rows (quantized weights
    dequantized first), so that each row's bits do not depend on the row
    count; ``norm`` (the block's ln2 as (scale, eps), x un-normed) is then
    the gate and up products' prologue."""
    shp = x.shape
    xt = x.reshape(-1, shp[-1])
    t, d = xt.shape
    kernel = _uses_kernel(backend)
    if kernel and step:
        h = F.silu(dense(xt, p["w1"], kernel=True, norm=norm)) * dense(
            xt, p["w3"], kernel=True, norm=norm)
        return dense(h, p["w2"], kernel=True).reshape(shp)
    if norm is not None:
        raise ValueError("ffn: a norm prologue is the steps' route's only")
    if isinstance(p["w1"], QTensor):
        d_ff = p["w1"].shape[-1]
        g = p["w1"].group or 256
        if kernel and not (t % 128 or d % 256 or d_ff % 256 or 256 % g):
            def qmm(a, qw):
                return ops.quant_matmul(a.contiguous(), qw, cfg).to(x.dtype)
            h = F.silu(qmm(xt, p["w1"])) * qmm(xt, p["w3"])
            return qmm(h, p["w2"]).reshape(shp)
    w1, w3, w2 = (asdense(p[n], x.dtype) for n in ("w1", "w3", "w2"))
    d_ff = w1.shape[1]
    if kernel and not (t % 128 or d % 256 or d_ff % 256):
        def mm(a, b):
            return ops.matmul(a.contiguous(), b, cfg).to(x.dtype)
    else:
        def mm(a, b):
            return torch.matmul(a.float(), b.float()).to(x.dtype)
    h = F.silu(mm(xt, w1)) * mm(xt, w3)
    return mm(h, w2).reshape(shp)


# -- MoE (top-k, optional shared experts) ---------------------------------------

def moe_default_capacity(t: int, e: int, k: int) -> int:
    """The moe() default per-expert capacity (factor 1.5, floor 8, clamped
    to the token count), `repro/models/layers.py:691`."""
    return min(t, max(8, int(1.5 * k * t / e)))


def moe_expert_ffn(xe, w1, w3, w2, comb, cfg: ModelConfig):
    """Per-expert gate/up/down over the padded dispatch buffer, scaled by
    the combine weights (`repro/models/layers.py:698-739`): xe (E,C,d),
    w1/w3 (E,d,F), w2 (E,F,d), comb (E,C) -> (E,C,d) float32.

    ``cfg.moe_backend="cuda"`` dispatches the grouped-expert kernel (bf16
    weights) or its dequant-fused twin (`QTensor` weights, when the int4
    group tiles d and F), with the expert axis as the coarsening axis
    (``cfg.moe_ffn_cfg``); an explicit degree the expert axis cannot tile
    takes the einsum path below, as in the reference.  That path rounds at
    every einsum, as the reference's fallback does."""
    e, c, d = xe.shape
    f = w1.shape[-1]
    if _uses_kernel(cfg.moe_backend):
        if isinstance(w1, QTensor):
            if w1.bits == 8 or (d % w1.group == 0 and f % w1.group == 0):
                rcfg = ops.resolve_moe(cfg.moe_ffn_cfg, xe, w1)
                if e % rcfg.degree == 0:
                    return ops.quant_moe_ffn(xe, w1, w3, w2, comb, rcfg)
            return _moe_einsum(xe, w1, w3, w2, comb)
        rcfg = ops.resolve_moe(cfg.moe_ffn_cfg, xe, w1)
        if e % rcfg.degree == 0:
            return ops.moe_ffn(xe, w1.to(xe.dtype), w3.to(xe.dtype),
                               w2.to(xe.dtype), comb, rcfg)
    return _moe_einsum(xe, w1, w3, w2, comb)


def _moe_einsum(xe, w1, w3, w2, comb):
    """The reference's einsum fallback of `moe_expert_ffn`."""
    w1, w3, w2 = (asdense(w, xe.dtype).float() for w in (w1, w3, w2))
    xf = xe.float()
    h = F.silu(torch.matmul(xf, w1).to(xe.dtype))
    h = (h * torch.matmul(xf, w3).to(xe.dtype)).float()
    ye = torch.matmul(h, w2).to(xe.dtype)
    return (ye * comb[..., None].to(ye.dtype)).float()


_COMBINE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                   "float16": torch.float16}


def moe(p, x, cfg: ModelConfig, *, capacity: int | None = None,
        renorm: bool = True, step: bool = False):
    """Top-k MoE with per-expert top-capacity dispatch
    (`repro/models/layers.py:742-801`, the single-device path; the
    expert-parallel `_moe_shardmap` is not ported).  x: (B,S,d) ->
    ((B,S,d), aux load-balance loss).  Overflow tokens are dropped;
    pad experts get -1e30 router logits; the combine-scatter accumulates
    in ``cfg.moe_combine_dtype``; shared experts run through `ffn` with
    ``cfg.ffn_backend`` (on a decode or verify ``step``, its step
    products), scaled by a sigmoid gate."""
    b, s, d = x.shape
    t = b * s
    e, k = cfg.n_experts, cfg.top_k
    e_pad = cfg.n_experts_padded
    xt = x.reshape(t, d)
    logits = (xt @ p["router"].to(xt.dtype)).float()
    if e_pad != e:
        logits = torch.where(torch.arange(e_pad, device=x.device) < e,
                             logits, torch.full_like(logits, -1e30))
    probs = torch.softmax(logits, dim=-1)
    w, idx = torch.topk(probs, k, dim=-1)                  # (T,k)
    if renorm:
        w = w / (w.sum(-1, keepdim=True) + 1e-9)

    onehot = F.one_hot(idx, e_pad).float()                 # (T,k,E_pad)
    frac = onehot.sum(dim=(0, 1)) / t
    aux = e * torch.sum(frac * probs.mean(dim=0))

    cap = capacity if capacity is not None else moe_default_capacity(t, e, k)
    cap = min(cap, t)
    tokw = torch.einsum("tke,tk->et", onehot, w)           # (E_pad,T)
    topw, topi = torch.topk(tokw, cap, dim=-1)             # (E_pad,C)
    live = topw > 0.0
    xe = xt[topi.reshape(-1)].reshape(e_pad, cap, d)
    xe = xe * live[..., None].to(xe.dtype)
    ye = moe_expert_ffn(xe, p["w1"], p["w3"], p["w2"], topw * live, cfg)
    cdt = _COMBINE_DTYPES[cfg.moe_combine_dtype]
    y = torch.zeros((t, d), dtype=cdt, device=x.device).index_add_(
        0, topi.reshape(-1), ye.reshape(-1, d).to(cdt))
    y = y.to(x.dtype)
    if cfg.n_shared_experts:
        gate = torch.sigmoid((xt @ p["shared_gate"].to(xt.dtype)).float()
                             ).to(x.dtype)
        y = y + ffn(p["shared"], xt, backend=cfg.ffn_backend,
                    step=step) * gate
    return y.reshape(b, s, d), aux
