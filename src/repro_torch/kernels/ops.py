"""Public wrappers of the ported kernel families (mirrors
`repro.kernels.ops` for the ops the ported paths run).

``cfg`` is a CoarseningConfig or a label ("con2", "gap4+simd2", "base");
``"auto"`` resolves to the uncoarsened config until the tuner is ported.
Tensors on the CPU take each kernel's plain PyTorch version; tensors on a
CUDA device take the hand-written kernel (or the call raises).

`flash_attention` and `flash_attention_sparse` are differentiable (a
`torch.autograd.Function` whose backward runs the dQ and dK/dV
kernels).  The other ops have no backward: their kernels fill outputs
that autograd cannot see through, so they raise when grad mode is on and
an input requires grad, instead of silently dropping the gradient.
"""
from __future__ import annotations

import torch

from repro_torch.core.coarsening import BASE, CoarseningConfig, resolve
from repro_torch.kernels import chunk_scan as _scan
from repro_torch.kernels import decode_attention as _decode
from repro_torch.kernels import ew_stream as _ew
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import gather_stream as _gather
from repro_torch.kernels import matmul as _matmul
from repro_torch.kernels import moe_ffn as _moe
from repro_torch.kernels import ref
from repro_torch.kernels import sparse_attention as _sparse
from repro_torch.kernels import stencil as _stencil


def _check_no_grad(name: str, *tensors) -> None:
    """Raise if autograd would need a gradient through a kernel that has
    no backward."""
    if torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.requires_grad for t in tensors):
        raise RuntimeError(f"{name} has no backward: call it under "
                           f"torch.no_grad() or on tensors that do not "
                           f"require grad (the trainer's FFN takes the "
                           f"plain product, ffn_backend='ref')")


def ew_stream(inputs, cfg: CoarseningConfig | str = BASE, *, ai: int = 6,
              variant: str = "base", block: int = 1024):
    """The paper's Fig. 6 streaming kernel (`repro/kernels/ops.py:85`):
    ``len(inputs)`` (N,) f32 streams -> (N,) f32 through a chain of
    ``ai * (len(inputs) + 1)`` ops under a divergence ``variant``."""
    _check_no_grad("ops.ew_stream", *inputs)
    return _ew.ew_stream(inputs, cfg, ai=ai, variant=variant, block=block)


def gather_stream(idx, tables, cfg: CoarseningConfig | str = BASE, *,
                  ai: int = 6, block: int = 1024):
    """``out[i] = chain(t0[idx[i]], ...)`` (`repro/kernels/ops.py:101`):
    idx (N,) int32, tables (T,) f32 -> (N,) f32."""
    _check_no_grad("ops.gather_stream", *tables)
    return _gather.gather_stream(idx, tables, cfg, ai=ai, block=block)


def stencil5(x, cfg: CoarseningConfig | str = BASE, *, block_rows: int = 8):
    """5-point edge-padded stencil (`repro/kernels/ops.py:166`): (rows,
    cols) f32 -> (rows, cols) f32, coarsened over row blocks."""
    _check_no_grad("ops.stencil5", x)
    return _stencil.stencil5(x, cfg, block_rows=block_rows)


def dp_scan(cost, cfg: CoarseningConfig | str = BASE):
    """Pathfinder DP min-scan (`repro/kernels/ops.py:177`): (rows, cols)
    f32 -> (rows, cols) f32; gapped coarsening raises ``ValueError``."""
    _check_no_grad("ops.dp_scan", cost)
    return _scan.dp_scan(cost, cfg)


def matmul(a, b, cfg: CoarseningConfig | str = BASE):
    """(m,k) @ (k,n) -> (m,n) float32 through the coarsened blocked kernel."""
    _check_no_grad("ops.matmul", a, b)
    return _matmul.coarsened_matmul(a, b, cfg)


def quant_matmul(a, qw, cfg: CoarseningConfig | str = BASE):
    """(m,k) @ QTensor (k,n) -> (m,n) float32 through the dequant-fused
    kernel (`repro/kernels/ops.py:137`)."""
    _check_no_grad("ops.quant_matmul", a)
    return _matmul.quant_matmul(a, qw, cfg)


def moe_ffn(xe, w1, w3, w2, comb, cfg: CoarseningConfig | str = BASE):
    """Grouped-expert fused gate/up/down FFN over the padded dispatch
    buffer (`repro/kernels/ops.py:583`).  xe (E,C,d); w1, w3 (E,d,F); w2
    (E,F,d); comb (E,C) -> (E,C,d) float32.  The coarsening axis is the
    expert axis."""
    _check_no_grad("ops.moe_ffn", xe, w1, w3, w2, comb)
    return _moe.moe_ffn(xe, w1, w3, w2, comb, cfg)


def quant_moe_ffn(xe, qw1, qw3, qw2, comb,
                  cfg: CoarseningConfig | str = BASE):
    """`moe_ffn` with QTensor expert weights (`repro/kernels/ops.py:606`),
    f32 throughout."""
    _check_no_grad("ops.quant_moe_ffn", xe, comb)
    return _moe.quant_moe_ffn(xe, qw1, qw3, qw2, comb, cfg)


def paged_decode_attention(q, k_pool, v_pool, block_table, pos,
                           cfg: CoarseningConfig | str = BASE, *,
                           window: int | None = None,
                           scale: float | None = None,
                           k_scale=None, v_scale=None):
    """Split-KV decode attention through a per-slot block table.
    q: (B,1,H,D); pools: (P,page_size,Hkv,D); block_table: (B,npp) int32;
    pos: (B,) int32 -> (B,1,H,D).  The coarsening axis is the slot's
    logical-page axis.  ``k_scale`` / ``v_scale`` (P,page_size,Hkv) f32
    mark int8 pools."""
    _check_no_grad("ops.paged_decode_attention", q, k_pool, v_pool)
    return _decode.paged_decode_attention(
        q, k_pool, v_pool, block_table, pos, cfg, window=window, scale=scale,
        k_scale=k_scale, v_scale=v_scale)


def decode_attention(q, k_cache, v_cache, pos,
                     cfg: CoarseningConfig | str = BASE, *, bkv: int = 128,
                     window: int | None = None, scale: float | None = None,
                     k_scale=None, v_scale=None):
    """Split-KV decode attention on a contiguous cache
    (`repro/kernels/ops.py:424`).  q: (B,1,H,D); caches: (B,S,Hkv,D); pos:
    (B,) int32 -> (B,1,H,D).  The coarsening axis is the kv-block axis
    (each split owns cfg.degree blocks of ``bkv`` rows).  ``k_scale`` /
    ``v_scale`` (B,S,Hkv) f32 mark int8 caches."""
    _check_no_grad("ops.decode_attention", q, k_cache, v_cache)
    return _decode.decode_attention(q, k_cache, v_cache, pos, cfg, bkv=bkv,
                                    window=window, scale=scale,
                                    k_scale=k_scale, v_scale=v_scale)


def flash_attention_verify(q, k_pool, v_pool, block_table, pos0,
                           cfg: CoarseningConfig | str = BASE, *,
                           window: int | None = None,
                           scale: float | None = None,
                           k_scale=None, v_scale=None):
    """Batched-verify attention through a per-slot block table
    (`repro/kernels/ops.py:534`): q (B,T,H,D), row t at cache position
    ``pos0[b] + t``; pools (P,page_size,Hkv,D); block_table (B,npp) int32;
    pos0 (B,) int32 -> (B,T,H,D).  The coarsening axis is the logical-page
    axis; ``k_scale`` / ``v_scale`` (P,page_size,Hkv) f32 mark int8
    pools."""
    _check_no_grad("ops.flash_attention_verify", q, k_pool, v_pool)
    return _decode.verify_attention(q, k_pool, v_pool, block_table, pos0,
                                    cfg, window=window, scale=scale,
                                    k_scale=k_scale, v_scale=v_scale)


class _FlashAttention(torch.autograd.Function):
    """`repro/kernels/ops.py:183-241` `_flash_vjp_fn`: the forward runs the
    residual kernel and saves (q, k, v, o, m, l); the backward takes the
    float32 cotangent, delta = sum(g * o) in float32 (:235), then the dQ
    kernel with the forward's ``cfg`` and the dK/dV kernel with
    ``bwd_cfg``, and casts each gradient to its input's type (:238)."""

    @staticmethod
    def forward(ctx, q, k, v, cfg, bwd_cfg, kw):
        o, m, l = _flash.flash_forward(q, k, v, cfg, residuals=True, **kw)
        ctx.save_for_backward(q, k, v, o, m, l)
        ctx.cfg, ctx.bwd_cfg, ctx.kw = cfg, bwd_cfg, kw
        return o

    @staticmethod
    def backward(ctx, g):
        q, k, v, o, m, l = ctx.saved_tensors
        g = g.float().contiguous()
        delta = (g * o).sum(dim=-1)                    # (B,H,Sq) f32
        dq = _flash.flash_bwd_dq(q, k, v, g, m, l, delta, ctx.cfg, **ctx.kw)
        dk, dv = _flash.flash_bwd_dkv(q, k, v, g, m, l, delta, ctx.bwd_cfg,
                                      **ctx.kw)
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None,
                None)


def flash_attention(q, k, v, cfg: CoarseningConfig | str = BASE, *,
                    bwd_cfg: CoarseningConfig | str | None = None,
                    bq: int = 128, bkv: int = 128, causal: bool = True,
                    window: int | None = None, scale: float | None = None):
    """Differentiable coarsened flash attention (`repro/kernels/ops.py:250`).
    q: (B,H,Sq,D); k, v: (B,Hkv,Sk,D) -> (B,H,Sq,D) float32.

    ``cfg`` coarsens the forward (and the dQ pass) on the q-row axis;
    ``bwd_cfg`` (default "auto") coarsens the dK/dV pass on the kv-block
    axis.  A call with grad off, or on inputs that need no gradient, runs
    the forward kernel without residuals (:197-200)."""
    cfg = resolve(cfg)
    bwd_cfg = resolve("auto" if bwd_cfg is None else bwd_cfg)
    kw = dict(bq=bq, bkv=bkv, causal=causal, window=window, scale=scale)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _FlashAttention.apply(q, k, v, cfg, bwd_cfg, kw)
    return _flash.flash_forward(q, k, v, cfg, **kw)


class _FlashSparse(torch.autograd.Function):
    """`repro/kernels/ops.py:283-356` `_flash_sparse_fn`: the forward runs
    the block-sparse kernel with residuals and saves (q, k, v, o, m, l).
    The backward reuses the DENSE backward kernels on those residuals
    (the index covers the pattern's mask exactly, so (m, l) are the
    dense-mask forward's): delta = sum(g * o), dQ at `BASE` (``cfg``'s
    degree is a live-slot degree, not a q-row one) and dK/dV at
    ``bwd_cfg``, under the same causal / window mask.  A global-stride
    pattern, which the dense kernels cannot express, differentiates the
    plain dense-mask oracle (`ref.sparse_attention`) instead, as the
    reference's rule does (:329-337): there the reference, too, computes
    outside any Pallas kernel."""

    @staticmethod
    def forward(ctx, q, k, v, idx, cfg, bwd_cfg, kw):
        o, m, l = _sparse.flash_sparse_fwd(q, k, v, idx, cfg, residuals=True,
                                           **kw)
        ctx.save_for_backward(q, k, v, o, m, l)
        ctx.bwd_cfg, ctx.kw = bwd_cfg, kw
        return o

    @staticmethod
    def backward(ctx, g):
        q, k, v, o, m, l = ctx.saved_tensors
        kw = dict(ctx.kw)
        gs = kw.pop("global_stride")
        g = g.float().contiguous()
        if gs:
            with torch.enable_grad():
                qkv = [t.detach().requires_grad_() for t in (q, k, v)]
                o_ref = ref.sparse_attention(
                    *qkv, causal=kw["causal"], window=kw["window"],
                    global_stride=gs, scale=kw["scale"])
                dq, dk, dv = torch.autograd.grad(o_ref, qkv, g)
        else:
            delta = (g * o).sum(dim=-1)                # (B,H,Sq) f32
            dq = _flash.flash_bwd_dq(q, k, v, g, m, l, delta, BASE, **kw)
            dk, dv = _flash.flash_bwd_dkv(q, k, v, g, m, l, delta,
                                          ctx.bwd_cfg, **kw)
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None,
                None, None)


def flash_attention_sparse(q, k, v, cfg: CoarseningConfig | str = BASE, *,
                           bwd_cfg: CoarseningConfig | str | None = None,
                           bq: int = 128, bkv: int = 128, causal: bool = True,
                           window: int | None = None,
                           global_stride: int | None = None,
                           scale: float | None = None,
                           backend: str = "cuda"):
    """Block-sparse flash attention over the per-q-block live-KV index
    (`repro/kernels/ops.py:368-409`).  q: (B,H,Sq,D); k, v: (B,Hkv,Sk,D)
    -> (B,H,Sq,D) float32.

    Each q block walks only the kv blocks its index row lists under the
    pattern {``causal``, ``window``, ``global_stride`` columns}; ``cfg``
    coarsens over the live-slot axis and ``bwd_cfg`` (default "auto") the
    dK/dV pass.  ``backend="ref"`` is the dense-mask oracle.  The index is
    built on the host once per geometry and uploaded once per device.  A
    call with grad off, or on inputs that need no gradient, runs the
    kernel without residuals."""
    if backend == "ref":
        return ref.sparse_attention(q, k, v, causal=causal, window=window,
                                    global_stride=global_stride, scale=scale)
    if backend != "cuda":
        raise ValueError(f"backend must be 'ref' or 'cuda', got {backend!r}")
    cfg = resolve(cfg)
    idx = _sparse.device_index(q.shape[2], k.shape[2], bq, bkv,
                               causal=causal, window=window,
                               global_stride=global_stride, device=q.device)
    kw = dict(bq=bq, bkv=bkv, causal=causal, window=window, scale=scale)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        bwd_cfg = resolve("auto" if bwd_cfg is None else bwd_cfg)
        return _FlashSparse.apply(q, k, v, idx, cfg, bwd_cfg,
                                  dict(kw, global_stride=global_stride))
    return _sparse.flash_sparse_fwd(q, k, v, idx, cfg,
                                    global_stride=global_stride, **kw)
