"""Plain PyTorch versions of the port's kernels.

Each computes its kernel's function in one untiled shot, as
`repro.kernels.ref` does for the Pallas kernels: the CPU path of every
wrapper, and the yardstick each CUDA kernel is held against on the card.
Coarsening redistributes work between thread blocks; it must not change
these results.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.quant.qtypes import QTensor, dequantize

NEG = -1e30


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    """`repro/models/layers.py:87`: float32 statistics, scale applied as
    (1 + scale), result in x's dtype."""
    dt = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * (1.0 + scale.float())).to(dt)


@functools.lru_cache(maxsize=64)
def _rope_freqs(hd: int, theta: float, device: torch.device) -> torch.Tensor:
    with torch.inference_mode(False):
        return 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                             device=device) / hd))


def rope_freqs(hd: int, theta: float, device=None) -> torch.Tensor:
    """(hd/2,) float32 1 / theta^(2i/hd), computed by torch once per (hd,
    theta, device) and kept (callers only read it)."""
    return _rope_freqs(hd, float(theta), torch.device(device or "cpu"))


def rope(x: torch.Tensor, pos: torch.Tensor,
         freqs: torch.Tensor) -> torch.Tensor:
    """x: (B,S,H,D); pos: (B,S) int.  Interleaved pairs (x[..., ::2],
    x[..., 1::2]) rotated in float32 (`repro/models/layers.py:103`)."""
    ang = pos[..., None].float() * freqs                     # (B,S,D/2)
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., ::2].float(), x[..., 1::2].float()
    out = torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.reshape(x.shape).to(x.dtype)


def qk_norm_rope(q: torch.Tensor, k: torch.Tensor, pos: torch.Tensor,
                 q_scale, k_scale, eps: float, freqs: torch.Tensor):
    """A step's q (..., H, D) and k (..., Hkv, D), their leading dims (B, T)
    or B * T, the rows of ``pos`` (B, T): `rmsnorm` per head (skipped
    where the scales are None) then `rope`, in q's and k's shapes and
    dtypes."""
    out = []
    for x, sc in ((q, q_scale), (k, k_scale)):
        y = x.reshape(*pos.shape, *x.shape[-2:])
        if sc is not None:
            y = rmsnorm(y, sc, eps)
        out.append(rope(y, pos, freqs).reshape(x.shape))
    return tuple(out)


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(m,k) @ (k,n) in float32 (`repro/kernels/ref.py:44`)."""
    return torch.matmul(a.float(), b.float())


def quant_matmul(a: torch.Tensor, qw: QTensor) -> torch.Tensor:
    """The dequant-fused matmul's function (`repro/kernels/matmul.py:87`
    `make_qkernel`): a cast to f32 against the dequantized f32 weight,
    f32 product -> (m,n) f32."""
    return torch.matmul(a.float(), dequantize(qw))


# -- grouped-expert MoE FFN (`repro/kernels/moe_ffn.py`) ------------------------

def moe_ffn(xe, w1, w3, w2, comb):
    """`repro/kernels/ref.py:158-172`: per expert
    ``(silu(xe@w1) * (xe@w3)) @ w2`` with f32 accumulation, the (C, F)
    intermediate rounded once to xe's dtype (as the Pallas kernel,
    `moe_ffn.py:62`), scaled by the combine weights.  xe (E,C,d);
    w1, w3 (E,d,F); w2 (E,F,d); comb (E,C) -> (E,C,d) f32."""
    x = xe.float()
    h = F.silu(torch.matmul(x, w1.float())) * torch.matmul(x, w3.float())
    ye = torch.matmul(h.to(xe.dtype).float(), w2.float())
    return ye * comb[..., None].float()


def quant_moe_ffn(xe, qw1: QTensor, qw3: QTensor, qw2: QTensor, comb):
    """The dequant-fused MoE kernel's function (`repro/kernels/moe_ffn.py:110`
    `make_qkernel`, :160-167): x cast to f32, the packed panes
    dequantized to f32, and f32 throughout — h is NOT rounded (the
    reference's own oracle, `repro/kernels/ops.py:619-623`, sends this
    kernel through `moe_ffn`, which rounds it)."""
    x = xe.float()
    h = F.silu(torch.matmul(x, dequantize(qw1))) \
        * torch.matmul(x, dequantize(qw3))
    return torch.matmul(h, dequantize(qw2)) * comb[..., None].float()


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


def gather_scales(scale_pool, block_table):
    """(P,ps,Hkv) scale pool + (B,npp) table -> (B, npp*ps, Hkv)."""
    b, npp = block_table.shape
    _, ps, hkv = scale_pool.shape
    return scale_pool[block_table.long()].reshape(b, npp * ps, hkv)


def paged_decode_attention(q, k_pool, v_pool, block_table, pos, *,
                           window=None, scale=None, k_scale=None,
                           v_scale=None):
    """Gather-to-contiguous oracle of the paged split-KV kernel: resolve the
    block table (int8 pools: and dequantize the gathered view with its
    scales), then dense decode attention."""
    k, v = gather_pages(k_pool, block_table), gather_pages(v_pool,
                                                           block_table)
    if k_scale is not None:
        k = k.float() * gather_scales(k_scale, block_table)[..., None]
        v = v.float() * gather_scales(v_scale, block_table)[..., None]
    return decode_attention(q, k, v, pos, window=window, scale=scale)


def verify_split_kv(q, k_pool, v_pool, block_table, pos0, *, degree=1,
                    gapped=False, window=None, scale=None, k_scale=None,
                    v_scale=None):
    """The paged split-KV kernels' own arithmetic, in one shot per split:
    the short-q verify kernel (`repro/kernels/decode_attention.py:380`
    `make_verify_kernel`) and, with T = 1, the paged decode kernel (:208
    `make_paged_kernel`).  Split ``si`` owns logical pages ``si*C + j``
    (consecutive) or ``j*(npp/C) + si`` (gapped), resolved through the
    block table; row t of a slot sits at cache position ``pos0 + t`` with
    its own causal / window mask; a split is live when its first row is
    at or before ``pos0 + T - 1`` and (with a window) its last row is past
    ``pos0 - window`` (:433-443), else it yields the empty partial;
    `combine` merges the splits.  The T*G rows of a kv head are flattened
    t-major, as `_qview` does (:528-538).  int8 pools (``k_scale`` /
    ``v_scale`` (P,ps,Hkv), the ``kv_bits=8`` branch) are dequantized row
    by row as the panes are read (:295-301).
    q: (B,T,H,D); pools: (P,ps,Hkv,D); block_table: (B,npp); pos0: (B,)
    -> (B,T,H,D) in q's dtype."""
    b, t, h, d = q.shape
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

    def panes(pool, sc):                                       # (B,Hkv,n,C*ps,D)
        x = pool[phys].float()                                 # (B,n,C,ps,Hkv,D)
        if sc is not None:
            x = x * sc[phys][..., None]
        return x.permute(0, 4, 1, 2, 3, 5).reshape(b, hkv, n_splits,
                                                   c * ps, d)

    cols = (lp[..., None] * ps + torch.arange(ps, device=dev)
            ).reshape(n_splits, c * ps)
    pos0 = pos0.to(torch.int64)
    tpos = (pos0[:, None] + torch.arange(t, device=dev))[:, :, None, None]
    mask = cols[None, None] <= tpos                            # (B,T,n,C*ps)
    if window is not None:
        mask = mask & (cols[None, None] > tpos - window)
    first, last = cols.amin(dim=1), cols.amax(dim=1)           # (n,)
    live = first[None] <= pos0[:, None] + (t - 1)              # (B,n)
    if window is not None:
        live = live & (last[None] > pos0[:, None] - window)
    mask = mask & live[:, None, :, None]
    mk = mask[:, None, :, None].expand(b, 1, t, g, n_splits, c * ps) \
        .reshape(b, 1, t * g, n_splits, c * ps)               # t-major rows
    qg = q.reshape(b, t, hkv, g, d).transpose(1, 2).reshape(
        b, hkv, t * g, d).float()
    s = torch.einsum("bhrd,bhnkd->bhrnk", qg, panes(k_pool, k_scale)) \
        * scale
    s = torch.where(mk, s, torch.full_like(s, NEG))
    m = s.amax(dim=-1)                                         # (B,Hkv,R,n)
    p = torch.exp(s - m[..., None]) * mk
    l = p.sum(dim=-1)
    acc = torch.einsum("bhrnk,bhnkd->bhrnd", p, panes(v_pool, v_scale))
    out = combine(m, l, acc)                                   # (B,Hkv,R,D)
    return out.reshape(b, hkv, t, g, d).transpose(1, 2).reshape(
        b, t, h, d).to(q.dtype)


def split_kv(q, k_cache, v_cache, pos, *, degree=1, gapped=False, bkv=128,
             window=None, scale=None, k_scale=None, v_scale=None):
    """The contiguous split-KV kernel's arithmetic
    (`repro/kernels/decode_attention.py:51` `make_kernel`): split ``si``
    owns C kv blocks of ``bkv`` rows, ``si*C + j`` (consecutive) or
    ``j*(S/(C*bkv)) + si`` (gapped, S/C rows apart), with the same
    live-split skip, masks and `combine` as the paged kernel.  That is the
    paged arithmetic on the cache viewed as pages of ``bkv`` rows, slot b
    owning pages ``b*S/bkv ...`` in order, which is how it is computed.
    int8 caches carry (B,S,Hkv) f32 ``k_scale`` / ``v_scale``.
    q: (B,1,H,D); caches: (B,S,Hkv,D); pos: (B,) -> (B,1,H,D)."""
    b, s, hkv, d = k_cache.shape
    if s % (degree * bkv):
        raise ValueError(f"cache len {s} not tileable by degree*bkv="
                         f"{degree * bkv}")
    npp = s // bkv
    table = torch.arange(b * npp, device=q.device).reshape(b, npp)

    def pages(x):
        return None if x is None else x.reshape(b * npp, bkv, *x.shape[2:])
    return verify_split_kv(q, pages(k_cache), pages(v_cache), table, pos,
                           degree=degree, gapped=gapped, window=window,
                           scale=scale, k_scale=pages(k_scale),
                           v_scale=pages(v_scale))


def verify_attention(q, k_cache, v_cache, pos0, *, window=None, scale=None):
    """Dense batched-verify oracle in float32 (`repro/kernels/ref.py:127`):
    row t of slot b sits at cache position ``pos0[b] + t`` and attends to
    every cache row at or before it.  q: (B,T,H,D); caches: (B,S,Hkv,D)
    -> (B,T,H,D) in q's dtype; T = 1 is `decode_attention`."""
    b, t, h, d = q.shape
    s, hkv = k_cache.shape[1], k_cache.shape[2]
    g = h // hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    qg = q.reshape(b, t, hkv, g, d).float()
    logits = torch.einsum("bthgd,bshd->bthgs", qg, k_cache.float()) * scale
    kpos = torch.arange(s, device=q.device)
    rows = pos0.to(torch.int64)[:, None] + torch.arange(t, device=q.device)
    mask = kpos[None, None, :] <= rows[:, :, None]             # (B,T,S)
    if window is not None:
        mask = mask & (kpos[None, None, :] > rows[:, :, None] - window)
    logits = torch.where(mask[:, :, None, None, :], logits,
                         torch.full_like(logits, NEG))
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bthgs,bshd->bthgd", p, v_cache.float())
    return out.reshape(b, t, h, d).to(q.dtype)


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


# -- flash attention (`repro/kernels/flash_attention.py`) ----------------------

def flash_check(sq, sk, *, degree, bq, bkv, causal, window, kv_axis=False):
    """The Pallas kernels' geometry rule: the coarsened axis tiles by
    ``degree`` blocks (q rows for the forward and dQ, kv rows for dK/dV),
    the other by its block; causal / window need Sq == Sk."""
    if kv_axis:
        tiles = sk % (degree * bkv) == 0 and sq % bq == 0
    else:
        tiles = sq % (degree * bq) == 0 and sk % bkv == 0
    if not tiles:
        raise ValueError(f"seq not tileable: Sq {sq}, Sk {sk}, degree "
                         f"{degree}, bq {bq}, bkv {bkv}")
    if (causal or window is not None) and sq != sk:
        raise ValueError(f"causal/window attention needs sq == sk (got {sq} "
                         f"vs {sk})")


def _flash_mask(sq, sk, causal, window, device):
    qi = torch.arange(sq, device=device)[:, None]
    ki = torch.arange(sk, device=device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=device)
    if causal:
        mask = mask & (ki <= qi)
    if window is not None:
        mask = mask & (ki > qi - window)
    return mask


def _flash_scores(q, k, causal, window, scale):
    """f32 scores (B,H,Sq,Sk) with GQA kv heads expanded, and the mask."""
    h, d = q.shape[1], q.shape[3]
    ke = k.float().repeat_interleave(h // k.shape[1], dim=1)
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), ke) * scale
    return s, _flash_mask(q.shape[2], k.shape[2], causal, window, q.device)


def flash_forward(q, k, v, *, degree=1, gapped=False, bq=128, bkv=128,
                  causal=True, window=None, scale=None, residuals=False):
    """The forward kernel's function (`flash_attention.py:119`
    `make_kernel`) in one shot, f32.  q: (B,H,Sq,D); k, v: (B,Hkv,Sk,D) ->
    o (B,H,Sq,D) f32, or (o, m, l) with the exact row max ``m`` and sum
    ``l`` (B,H,Sq) of the online softmax.  Masked entries weigh exactly 0;
    a fully masked row keeps m = NEG, l = 0 and o = 0.  The coarsening
    (``degree``, ``gapped``) and the blocks only redistribute the work, so
    they are checked for tiling and change no result."""
    del gapped
    flash_check(q.shape[2], k.shape[2], degree=degree, bq=bq, bkv=bkv,
                causal=causal, window=window)
    s, mask = _flash_scores(q, k, causal, window, scale)
    s = torch.where(mask, s, torch.full_like(s, NEG))
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None]) * mask
    l = p.sum(dim=-1)
    ve = v.float().repeat_interleave(q.shape[1] // v.shape[1], dim=1)
    o = torch.einsum("bhqk,bhkd->bhqd", p, ve)
    o = o / torch.where(l == 0.0, torch.ones_like(l), l)[..., None]
    return (o, m, l) if residuals else o


def _flash_bwd_p_ds(q, k, v, do, m, l, delta, causal, window, scale):
    """The backward kernels' recompute (:273-279): p from the saved (m, l)
    (the double `where` keeps masked entries at 0 in fully masked rows),
    dp = dO V^T, ds = p (dp - delta).  -> (p, ds) f32 (B,H,Sq,Sk)."""
    s, mask = _flash_scores(q, k, causal, window, scale)
    lg = torch.where(l == 0.0, torch.ones_like(l), l)
    p = torch.exp(torch.where(mask, s - m[..., None],
                              torch.full_like(s, NEG))) / lg[..., None]
    ve = v.float().repeat_interleave(q.shape[1] // v.shape[1], dim=1)
    dp = torch.einsum("bhqd,bhkd->bhqk", do.float(), ve)
    return p, p * (dp - delta[..., None])


def flash_bwd_prep(o, g):
    """The backward's preprocessing pass (`flash_attention.flash_bwd_prep`):
    the cotangent g rounded to bf16, as the backward kernels read it, and
    delta = sum(g * o) in float32, the reference's line outside its Pallas
    kernels (`repro/kernels/ops.py:235`) -> (do bf16, delta (B,H,Sq))."""
    return g.to(torch.bfloat16), (g * o).sum(-1)


def flash_bwd_dq(q, k, v, do, m, l, delta, *, degree=1, gapped=False,
                 bq=128, bkv=128, causal=True, window=None, scale=None):
    """The dQ kernel's function (:226 `make_bwd_dq_kernel`), f32:
    dq = ds K scale.  do: (B,H,Sq,D); m, l, delta: (B,H,Sq) ->
    (B,H,Sq,D) f32."""
    del gapped
    flash_check(q.shape[2], k.shape[2], degree=degree, bq=bq, bkv=bkv,
                causal=causal, window=window)
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[3])
    _, ds = _flash_bwd_p_ds(q, k, v, do, m, l, delta, causal, window, scale)
    ke = k.float().repeat_interleave(q.shape[1] // k.shape[1], dim=1)
    return torch.einsum("bhqk,bhkd->bhqd", ds, ke) * scale


def flash_bwd_dkv(q, k, v, do, m, l, delta, *, degree=1, gapped=False,
                  bq=128, bkv=128, causal=True, window=None, scale=None):
    """The dK/dV kernel's function (:315 `make_bwd_dkv_kernel`), f32:
    per q-head dv = p^T dO and dk = ds^T Q scale, then summed over each
    kv head's GQA group (:445-448) -> (dk, dv) (B,Hkv,Sk,D) f32."""
    del gapped
    flash_check(q.shape[2], k.shape[2], degree=degree, bq=bq, bkv=bkv,
                causal=causal, window=window, kv_axis=True)
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[3])
    p, ds = _flash_bwd_p_ds(q, k, v, do, m, l, delta, causal, window, scale)
    b, h, _, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    dv = torch.einsum("bhqk,bhqd->bhkd", p, do.float())
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q.float()) * scale
    return (dk.reshape(b, hkv, h // hkv, sk, d).sum(dim=2),
            dv.reshape(b, hkv, h // hkv, sk, d).sum(dim=2))


# -- block-sparse flash attention (`repro/kernels/sparse_attention.py`) -------

def sparse_attention(q, k, v, *, causal=True, window=None,
                     global_stride=None, scale=None):
    """The dense-mask oracle (`sparse_attention.py:157-178`
    `ref_sparse_attention`): q (B,H,Sq,D), k, v (B,Hkv,Sk,D) -> (B,H,Sq,D)
    float32 under the pattern's element mask (causal, window, global-stride
    columns).  Differentiable: the gradient of a global-stride pattern in
    training (`ops.flash_attention_sparse`)."""
    from repro_torch.kernels.sparse_attention import _element_mask
    b, h, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    if hkv != h:
        k = k.repeat_interleave(h // hkv, dim=1)
        v = v.repeat_interleave(h // hkv, dim=1)
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    mask = _element_mask(torch.arange(sq, device=q.device)[:, None],
                         torch.arange(sk, device=q.device)[None, :],
                         causal=causal, window=window,
                         global_stride=global_stride)
    logits = torch.where(mask, logits, torch.full_like(logits, NEG))
    p = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float())


def flash_sparse(q, k, v, idx, *, degree=1, gapped=False, bq=128, bkv=128,
                 causal=True, window=None, global_stride=None, scale=None):
    """The block-sparse forward's function (`sparse_attention.py:183`
    `make_kernel`) as a walk of the live index in the kernel's slot order:
    step si takes slot si*C + j (consecutive) or j*seg + si (gapped, seg
    = max_live / C) for j < C, each through the online softmax of
    (:236-252), vectorised over the q blocks; a NULL slot adds exactly
    nothing (p 0, rescale 1, its V read as 0), which is the kernel's skip.
    idx: (Sq/bq, max_live) int (array or tensor) -> (o (B,H,Sq,D), m, l
    (B,H,Sq)) float32, with the reference's ``l == 0`` guard (:262-265)."""
    from repro_torch.kernels.sparse_attention import _element_mask
    b, h, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    g, nq, nkb = h // hkv, sq // bq, sk // bkv
    if not isinstance(idx, torch.Tensor):
        idx = torch.tensor(np.asarray(idx))
    idx = idx.to(device=q.device, dtype=torch.long)
    max_live = idx.shape[1]
    if max_live % degree:
        raise ValueError("live-slot list not tileable by degree")
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    seg = max_live // degree
    qf = q.float().reshape(b, hkv, g, nq, bq, d)
    kb = k.float().reshape(b, hkv, nkb, bkv, d)
    vb = v.float().reshape(b, hkv, nkb, bkv, d)
    rows = torch.arange(sq, device=q.device).reshape(nq, bq, 1)
    cols0 = torch.arange(bkv, device=q.device)
    m = torch.full((b, hkv, g, nq, bq), NEG, device=q.device)
    l = torch.zeros((b, hkv, g, nq, bq), device=q.device)
    acc = torch.zeros((b, hkv, g, nq, bq, d), device=q.device)
    for si in range(seg):
        for j in range(degree):
            lb = idx[:, j * seg + si if gapped else si * degree + j]
            live = lb >= 0                                   # (nq,)
            lbc = lb.clamp(min=0)
            cols = (lbc[:, None] * bkv + cols0)[:, None, :]  # (nq, 1, bkv)
            mask = _element_mask(rows, cols, causal=causal, window=window,
                                 global_stride=global_stride) \
                & live[:, None, None]                        # (nq, bq, bkv)
            kk = kb[:, :, lbc]                               # (b,hkv,nq,bkv,d)
            vv = torch.where(live[:, None, None], vb[:, :, lbc], 0.0)
            s = torch.einsum("bhgqrd,bhqkd->bhgqrk", qf, kk) * scale
            s = torch.where(mask, s, torch.full_like(s, NEG))
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None]) * mask
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bhgqrk,bhqkd->bhgqrd", p, vv)
            m = m_new
    lg = torch.where(l == 0.0, torch.ones_like(l), l)
    o = (acc / lg[..., None]).reshape(b, h, sq, d)
    return o, m.reshape(b, h, sq), l.reshape(b, h, sq)


# -- the paper's microbenchmarks (`repro/kernels/ew_stream.py:37-104`,
#    `repro/kernels/ref.py:19-72`), in the reference's order of operations --

VARIANTS = ("base", "if_id", "if_in", "for_const_if_id", "for_in_if_in",
            "div2", "div4")
FOR_CONST_TRIPS = 5
FOR_IN_MAX_TRIPS = 8


def _arith_chain(regs: list, n_arith: int) -> torch.Tensor:
    """The Fig. 6 body: ``n_arith`` ops, each +, - or the mean of the
    accumulator and the next register (products by 0.5 only, so exact)."""
    acc = regs[0]
    n = len(regs)
    for t in range(n_arith):
        r = regs[(t + 1) % n]
        m = t % 3
        if m == 0:
            acc = acc + r
        elif m == 1:
            acc = acc - r
        else:
            acc = acc * 0.5 + r * 0.5
    return acc


def _bucket(x: torch.Tensor, scale: float, mod: int) -> torch.Tensor:
    """``floor(|x| * scale) as int32 % mod``: the data-dependent predicates."""
    return torch.floor(torch.abs(x) * scale).to(torch.int32) % mod


def _global_ids(plan, i: int) -> torch.Tensor:
    """Global element index of each (k, j) element of program i's tile."""
    c, b, g = plan.cfg.degree, plan.block, plan.grid
    k = torch.arange(c)[:, None]
    j = torch.arange(b)[None, :]
    if plan.contiguous:
        return (i * c + k) * b + j
    return k * (g * b) + i * b + j


def _variant_compute(variant: str, regs: list, gids: torch.Tensor,
                     n_arith: int) -> torch.Tensor:
    """The divergence variant around the arithmetic chain."""
    if variant == "base":
        return _arith_chain(regs, n_arith)
    if variant == "if_id":
        taken = _arith_chain(regs, n_arith)
        return torch.where(gids % 2 == 0, taken, regs[0])
    if variant == "if_in":
        taken = _arith_chain(regs, n_arith)
        return torch.where(_bucket(regs[-1], 16.0, 2) == 0, taken, regs[0])
    if variant == "for_const_if_id":
        acc = regs[0]
        for _ in range(FOR_CONST_TRIPS):
            taken = _arith_chain([acc] + regs[1:],
                                 max(1, n_arith // FOR_CONST_TRIPS))
            acc = torch.where(gids % 2 == 0, taken, acc)
        return acc
    if variant == "for_in_if_in":
        bound = _bucket(regs[-1], 8.0, FOR_IN_MAX_TRIPS)
        pred_in = _bucket(regs[-2], 16.0, 2) == 0
        acc = regs[0]
        for t in range(FOR_IN_MAX_TRIPS):
            taken = _arith_chain([acc] + regs[1:],
                                 max(1, n_arith // FOR_IN_MAX_TRIPS))
            acc = torch.where((t < bound) & pred_in, taken, acc)
        return acc
    if variant in ("div2", "div4"):
        deg = 2 if variant == "div2" else 4
        sel = _bucket(regs[-1], 16.0, deg)
        per_path = max(1, n_arith)
        out = _arith_chain(regs, per_path)
        for p in range(1, deg):
            rot = p % len(regs)
            alt = _arith_chain(regs[rot:] + regs[:rot], per_path)
            out = torch.where(sel == p, alt, out)
        return out
    raise ValueError(f"unknown variant {variant!r}")


def ew_stream(inputs, *, ai: int, variant: str = "base") -> torch.Tensor:
    """The streaming kernel's function (`repro/kernels/ref.py:19`): whole
    array, no tiling; element i's id is i."""
    n = inputs[0].shape[0]
    n_arith = ai * (len(inputs) + 1)
    regs = [x.reshape(1, n) for x in inputs]
    gids = torch.arange(n, device=inputs[0].device).reshape(1, n)
    return _variant_compute(variant, regs, gids, n_arith).reshape(n)


def gather_stream(tables, idx, *, ai: int) -> torch.Tensor:
    """``out[i] = chain(t0[idx[i]], ...)`` (`repro/kernels/ref.py:32`)."""
    regs = [t[idx.long()] for t in tables]
    return _arith_chain(regs, ai * (len(tables) + 1))


STENCIL_COEF = (0.5, 0.125, 0.125, 0.125, 0.125)  # centre, n, s, w, e


def stencil5(x: torch.Tensor, coef: tuple = STENCIL_COEF) -> torch.Tensor:
    """5-point stencil with edge padding (`repro/kernels/ref.py:52`; the
    Pallas kernel's shifted copies, `stencil.py:23-26`, are the same rows),
    summed left to right as both."""
    c0, cn, cs, cw, ce = coef
    xp = torch.cat([x[:1], x, x[-1:]], dim=0)
    xp = torch.cat([xp[:, :1], xp, xp[:, -1:]], dim=1)
    return (c0 * x + cn * xp[:-2, 1:-1] + cs * xp[2:, 1:-1]
            + cw * xp[1:-1, :-2] + ce * xp[1:-1, 2:])


def dp_scan(cost: torch.Tensor) -> torch.Tensor:
    """Pathfinder DP (`repro/kernels/ref.py:61`): row t = cost[t] +
    min(row t-1 shifted -1, 0, +1), edges clamped; row 0 = cost[0]."""
    out = torch.empty_like(cost)
    prev = out[0] = cost[0]
    for t in range(1, cost.shape[0]):
        left = torch.cat([prev[:1], prev[:-1]])
        right = torch.cat([prev[1:], prev[-1:]])
        out[t] = cost[t] + torch.minimum(prev, torch.minimum(left, right))
        prev = out[t]
    return out


def embed_gather(ids: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """``out[i, :] = table[ids[i], :]`` as float32 (`repro/kernels/
    embed_gather.py:30-66`: the Pallas kernel's output is float32 whatever
    the table's type, :58).  Ids out of range follow the Pallas body's
    in-VMEM index: -V <= id < 0 wraps from the end of the table (id + V),
    then the index clamps to [0, V-1] (an id past the table reads row V-1,
    an id below -V row 0)."""
    vocab = table.shape[0]
    i = ids.long()
    return table[torch.where(i < 0, i + vocab, i).clamp(0, vocab - 1)].float()


def windowed_gather(idx: torch.Tensor, tbl: torch.Tensor,
                    ai: int = 6) -> torch.Tensor:
    """``out[i] = chain(tbl[idx[i]])`` with ``2 * ai`` ops
    (`repro/kernels/windowed_gather.py:106`): the one-table gather of
    `gather_stream`, whatever window the kernel stages it through."""
    return _arith_chain([tbl[idx.long()].reshape(1, -1)], ai * 2).reshape(-1)


# -- Mamba-2 SSD and RG-LRU (`repro/kernels/ref.py:177`, `:257-268`) ----------

def ssd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
        C: torch.Tensor, chunk: int = 64) -> torch.Tensor:
    """Naive (quadratic-in-S, exact) SSD oracle.

    x:(b,s,h,p) dt:(b,s,h) A:(h,) B:(b,s,g,n) C:(b,s,g,n); g divides h.
    y[t] = sum_{u<=t} C[t]·B[u] * exp(sum_{u<v<=t} dA[v]) * dt[u] * x[u].
    ``chunk`` is unused, as in the reference."""
    del chunk
    b, s, h, p = x.shape
    rep = h // B.shape[2]
    Bh = B.repeat_interleave(rep, dim=2)                # (b,s,h,n)
    Ch = C.repeat_interleave(rep, dim=2)
    cum = torch.cumsum(dt * A[None, None, :], dim=1)    # (b,s,h)
    diff = cum[:, :, None, :] - cum[:, None, :, :]      # (b,t,u,h)
    tids = torch.arange(s, device=x.device)
    causal = (tids[:, None] >= tids[None, :])[None, :, :, None]
    # double where: the non-causal exponent is clamped before exp
    diff = torch.where(causal, diff, 0.0)
    L = torch.where(causal, torch.exp(diff), 0.0)
    CB = torch.einsum("bthn,buhn->btuh", Ch, Bh)
    W = CB * L * dt[:, None, :, :]
    return torch.einsum("btuh,buhp->bthp", W, x)


RGLRU_C = 8.0


def softplus(x: torch.Tensor) -> torch.Tensor:
    """JAX's softplus, ``logaddexp(x, 0)``: max(x, 0) + log1p(exp(-|x|)),
    with no threshold (unlike `F.softplus`)."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-x.abs()))


def rglru(x: torch.Tensor, r: torch.Tensor, i: torch.Tensor,
          a_param: torch.Tensor) -> torch.Tensor:
    """RG-LRU oracle: h_t = a_t * h_{t-1} + sqrt(1-a_t^2) * (i_t * x_t),
    the sequential recurrence from h = 0.

    x,r,i: (b,s,d) (r,i are pre-sigmoid gates), a_param: (d,) pre-softplus.
    a_t = exp(-c * softplus(a_param) * sigmoid(r_t))."""
    rg = torch.sigmoid(r)
    ig = torch.sigmoid(i)
    log_a = -RGLRU_C * softplus(a_param)[None, None, :] * rg   # (b,s,d)
    a = torch.exp(log_a)
    gated = ig * x
    mult = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-12))
    b, s, d = x.shape
    h = torch.zeros((b, d), dtype=torch.float32, device=x.device)
    out = torch.empty((b, s, d), dtype=torch.float32, device=x.device)
    for t in range(s):
        h = a[:, t] * h + mult[:, t] * gated[:, t]
        out[:, t] = h
    return out
