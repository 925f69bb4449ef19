"""Public wrappers of the ported kernel families (mirrors
`repro.kernels.ops` for the ops the ported paths run).

``cfg`` is a CoarseningConfig, a label ("con2", "gap4+simd2", "base") or
``"auto"``.  Each op files its call under the reference op's tuner key
(family, shape, dtype and params, `repro/kernels/ops.py`) through
`resolve_cfg`, with ``backend="cuda"``: on CUDA tensors ``"auto"`` resolves
through the tuning cache (`repro_torch.tune`; a miss ranks by the H100
bound, which picks base, and persists it).  Tensors on the CPU take each
kernel's plain PyTorch version, and there ``"auto"`` is base, without the
tuner or the cache file.  Tensors on a CUDA device take the hand-written
kernel (or the call raises).

`flash_attention` and `flash_attention_sparse` are differentiable (a
`torch.autograd.Function` whose backward runs the dQ and dK/dV
kernels).  The other ops have no backward: their kernels fill outputs
that autograd cannot see through, so they raise when grad mode is on and
an input requires grad, instead of silently dropping the gradient.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.core.coarsening import BASE, CoarseningConfig
from repro_torch.kernels import chunk_scan as _scan
from repro_torch.kernels import decode_attention as _decode
from repro_torch.kernels import embed_gather as _embed
from repro_torch.kernels import ew_stream as _ew
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import gather_stream as _gather
from repro_torch.kernels import matmul as _matmul
from repro_torch.kernels import moe_ffn as _moe
from repro_torch.kernels import ref
from repro_torch.kernels import rglru as _rglru
from repro_torch.kernels import sparse_attention as _sparse
from repro_torch.kernels import ssd as _ssd
from repro_torch.kernels import stencil as _stencil
from repro_torch.quant.qtypes import QTensor


# the reference matmul's blocks (`repro/kernels/ops.py:119`), which its
# tuner key carries whatever tiles the port's kernel uses
MATMUL_BLOCKS = dict(bm=128, bn=128, bk=256)


def dtype_name(t: torch.Tensor) -> str:
    """The dtype's name as JAX spells it ("bfloat16", "int8", ...)."""
    return str(t.dtype).removeprefix("torch.")


def backend_of(t: torch.Tensor) -> str:
    """"cuda" for a tensor on the card (its kernel runs, and "auto" goes
    through the tuner); "ref" for the plain path of any other tensor."""
    return "cuda" if t.device.type == "cuda" else "ref"


@functools.lru_cache(maxsize=1024)
def _auto_cfg(cache_path, family, shape, dtype, backend, params):
    from repro_torch.tune import KernelSpec, autotune, default_cache
    spec = KernelSpec(family=family, shape=shape, dtype=dtype,
                      backend=backend, params=params)
    return autotune(spec, cache=default_cache())


def resolve_cfg(cfg, family: str, shape, *, dtype: str = "float32",
                backend: str = "cuda", **params) -> CoarseningConfig:
    """Normalise an op's ``cfg`` (`repro/kernels/ops.py:55-75`): a
    CoarseningConfig passes through, a label is parsed, and ``"auto"``
    goes through the tuner, memoised per cache path so that repointing
    ``REPRO_TORCH_TUNE_CACHE`` takes effect.  ``backend="ref"`` (the plain
    path) resolves ``"auto"`` to base and touches neither the tuner nor the
    cache file.  The key is the REAL array dtype plus the tuning params,
    as the reference files it."""
    if isinstance(cfg, CoarseningConfig):
        return cfg
    if cfg == "auto":
        if backend == "ref":
            return BASE
        from repro_torch.tune import default_cache_path
        return _auto_cfg(default_cache_path(), family,
                         tuple(int(s) for s in shape), str(dtype), backend,
                         tuple(sorted(params.items())))
    return CoarseningConfig.parse(cfg)


def _check_no_grad(name: str, *tensors) -> None:
    """Raise if autograd would need a gradient through a kernel that has
    no backward."""
    if torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.requires_grad for t in tensors):
        raise RuntimeError(f"{name} has no backward: call it under "
                           f"torch.no_grad() or on tensors that do not "
                           f"require grad (the trainer's FFN takes the "
                           f"plain product, ffn_backend='ref')")


# One key builder per attention and MoE family: the op and the layer
# dispatch (`repro_torch.models.layers`, which resolves before its takes
# rules) both file their call through these, so the key is built once a
# call and in one place.  A resolved CoarseningConfig passes through.

def _kv_bits(k_scale) -> dict:
    return {"kv_bits": 8} if k_scale is not None else {}


def resolve_paged(cfg, q, k_pool, block_table, *, window=None,
                  k_scale=None) -> CoarseningConfig:
    """The ``decode_attention_paged`` key (`repro/kernels/ops.py:499`): q
    (B,1,H,D), pools (P,page_size,Hkv,D), block_table (B,npp)."""
    b, _, h, d = q.shape
    _, ps, hkv, _ = k_pool.shape
    return resolve_cfg(cfg, "decode_attention_paged",
                       (b, h, hkv, block_table.shape[1], d),
                       dtype=dtype_name(k_pool), backend=backend_of(q),
                       page_size=ps, window=window or 0, **_kv_bits(k_scale))


def resolve_decode(cfg, q, k_cache, *, bkv=128, window=None,
                   k_scale=None) -> CoarseningConfig:
    """The ``decode_attention`` key (`repro/kernels/ops.py:443`): q
    (B,1,H,D), caches (B,S,Hkv,D)."""
    b, _, h, d = q.shape
    s, hkv = k_cache.shape[1], k_cache.shape[2]
    return resolve_cfg(cfg, "decode_attention", (b, h, hkv, s, d),
                       dtype=dtype_name(k_cache), backend=backend_of(q),
                       bkv=bkv, window=window or 0, **_kv_bits(k_scale))


def resolve_verify(cfg, q, k_pool, block_table, *, window=None,
                   k_scale=None) -> CoarseningConfig:
    """The ``flash_attention_verify`` key (`repro/kernels/ops.py:560`): q
    (B,T,H,D), pools (P,page_size,Hkv,D), block_table (B,npp)."""
    b, t, h, d = q.shape
    _, ps, hkv, _ = k_pool.shape
    return resolve_cfg(cfg, "flash_attention_verify",
                       (b, h, hkv, t, block_table.shape[1], d),
                       dtype=dtype_name(k_pool), backend=backend_of(q),
                       page_size=ps, window=window or 0, **_kv_bits(k_scale))


def _flash_shape(q, k) -> tuple:
    """The flash families' spec shape (B, H, Hkv, Sq, Sk, D)."""
    b, h, sq, d = q.shape
    return (b, h, k.shape[1], sq, k.shape[2], d)


def resolve_flash(cfg, q, k, *, bq=128, bkv=128, causal=True,
                  bwd=False) -> CoarseningConfig:
    """The ``flash_attention`` key (``bwd``: ``flash_attention_bwd``,
    `repro/kernels/ops.py:267`): q (B,H,Sq,D), k (B,Hkv,Sk,D)."""
    return resolve_cfg(cfg, "flash_attention_bwd" if bwd
                       else "flash_attention", _flash_shape(q, k),
                       dtype=dtype_name(q), backend=backend_of(q), bq=bq,
                       bkv=bkv, causal=bool(causal))


@functools.lru_cache(maxsize=256)
def sparse_extent(sq, sk, bq, bkv, causal, window, global_stride) -> tuple:
    """(max_live, n_live) of the pattern's live-KV index: its padded width
    and its live slot count."""
    host = _sparse.build_block_index(sq, sk, bq, bkv, causal=causal,
                                     window=window,
                                     global_stride=global_stride)
    return int(host.shape[1]), int((host >= 0).sum())


def resolve_flash_sparse(cfg, q, k, *, bq=128, bkv=128, causal=True,
                         window=None, global_stride=None) -> CoarseningConfig:
    """The ``flash_attention_sparse`` key (`repro/kernels/ops.py:395`):
    the flash key plus the pattern and its live-KV index's width and live
    slot count."""
    max_live, n_live = sparse_extent(q.shape[2], k.shape[2], bq, bkv,
                                     bool(causal), window, global_stride)
    return resolve_cfg(
        cfg, "flash_attention_sparse", _flash_shape(q, k),
        dtype=dtype_name(q), backend=backend_of(q), bq=bq, bkv=bkv,
        causal=bool(causal), window=window or 0, gstride=global_stride or 0,
        max_live=max_live, n_live=n_live)


def resolve_moe(cfg, xe, w1) -> CoarseningConfig:
    """The ``moe_ffn`` key (`repro/kernels/ops.py:592, 615`): xe (E,C,d)
    and w1 (E,d,F), a tensor or a packed QTensor (adding its bits and
    group)."""
    q = {"wbits": w1.bits, "group": w1.group} if isinstance(w1, QTensor) \
        else {}
    return resolve_cfg(cfg, "moe_ffn", (*xe.shape, w1.shape[-1]),
                       dtype=dtype_name(xe), backend=backend_of(xe), **q)


def ew_stream(inputs, cfg: CoarseningConfig | str = BASE, *, ai: int = 6,
              variant: str = "base", block: int = 1024):
    """The paper's Fig. 6 streaming kernel (`repro/kernels/ops.py:85`):
    ``len(inputs)`` (N,) f32 streams -> (N,) f32 through a chain of
    ``ai * (len(inputs) + 1)`` ops under a divergence ``variant``."""
    _check_no_grad("ops.ew_stream", *inputs)
    x = inputs[0]
    cfg = resolve_cfg(cfg, "ew_stream", (x.shape[0],), dtype=dtype_name(x),
                      backend=backend_of(x), n_loads=len(inputs), ai=ai,
                      variant=variant, block=block)
    return _ew.ew_stream(inputs, cfg, ai=ai, variant=variant, block=block)


def gather_stream(idx, tables, cfg: CoarseningConfig | str = BASE, *,
                  ai: int = 6, block: int = 1024):
    """``out[i] = chain(t0[idx[i]], ...)`` (`repro/kernels/ops.py:101`):
    idx (N,) int32, tables (T,) f32 -> (N,) f32."""
    _check_no_grad("ops.gather_stream", *tables)
    t = tables[0]
    cfg = resolve_cfg(cfg, "gather_stream", (idx.shape[0], t.shape[0]),
                      dtype=dtype_name(t), backend=backend_of(t),
                      n_loads=len(tables), ai=ai, block=block)
    return _gather.gather_stream(idx, tables, cfg, ai=ai, block=block)


def stencil5(x, cfg: CoarseningConfig | str = BASE, *, block_rows: int = 8):
    """5-point edge-padded stencil (`repro/kernels/ops.py:166`): (rows,
    cols) f32 -> (rows, cols) f32, coarsened over row blocks."""
    _check_no_grad("ops.stencil5", x)
    cfg = resolve_cfg(cfg, "stencil5", x.shape, dtype=dtype_name(x),
                      backend=backend_of(x), block_rows=block_rows)
    return _stencil.stencil5(x, cfg, block_rows=block_rows)


def dp_scan(cost, cfg: CoarseningConfig | str = BASE):
    """Pathfinder DP min-scan (`repro/kernels/ops.py:177`): (rows, cols)
    f32 -> (rows, cols) f32; gapped coarsening raises ``ValueError``."""
    _check_no_grad("ops.dp_scan", cost)
    cfg = resolve_cfg(cfg, "dp_scan", cost.shape, dtype=dtype_name(cost),
                      backend=backend_of(cost))
    return _scan.dp_scan(cost, cfg)


def matmul(a, b, cfg: CoarseningConfig | str = BASE):
    """(m,k) @ (k,n) -> (m,n) float32 through the coarsened blocked kernel."""
    _check_no_grad("ops.matmul", a, b)
    m, k, n = a.shape[0], a.shape[-1], b.shape[-1]
    cfg = resolve_cfg(cfg, "matmul", (m, n, k), dtype=dtype_name(a),
                      backend=backend_of(a), **MATMUL_BLOCKS)
    if not _matmul.tileable(m, n, k, cfg):
        # the kernel's whole-tile rule (its base-only ragged tiles serve
        # the decode and verify steps, `matmul.step_matmul`)
        raise ValueError(f"matmul ({m},{n},{k}) under {cfg.label} is not "
                         f"tileable by the kernel")
    return _matmul.coarsened_matmul(a, b, cfg)


def quant_matmul(a, qw, cfg: CoarseningConfig | str = BASE):
    """(m,k) @ QTensor (k,n) -> (m,n) float32 through the dequant-fused
    kernel (`repro/kernels/ops.py:137`)."""
    _check_no_grad("ops.quant_matmul", a)
    cfg = resolve_cfg(cfg, "matmul", (a.shape[0], qw.shape[-1], a.shape[-1]),
                      dtype=dtype_name(a), backend=backend_of(a),
                      **MATMUL_BLOCKS, wbits=qw.bits, group=qw.group)
    return _matmul.quant_matmul(a, qw, cfg)


def moe_ffn(xe, w1, w3, w2, comb, cfg: CoarseningConfig | str = BASE):
    """Grouped-expert fused gate/up/down FFN over the padded dispatch
    buffer (`repro/kernels/ops.py:583`).  xe (E,C,d); w1, w3 (E,d,F); w2
    (E,F,d); comb (E,C) -> (E,C,d) float32.  The coarsening axis is the
    expert axis."""
    _check_no_grad("ops.moe_ffn", xe, w1, w3, w2, comb)
    cfg = resolve_moe(cfg, xe, w1)
    return _moe.moe_ffn(xe, w1, w3, w2, comb, cfg)


def quant_moe_ffn(xe, qw1, qw3, qw2, comb,
                  cfg: CoarseningConfig | str = BASE):
    """`moe_ffn` with QTensor expert weights (`repro/kernels/ops.py:606`),
    f32 throughout."""
    _check_no_grad("ops.quant_moe_ffn", xe, comb)
    cfg = resolve_moe(cfg, xe, qw1)
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
    cfg = resolve_paged(cfg, q, k_pool, block_table, window=window,
                        k_scale=k_scale)
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
    cfg = resolve_decode(cfg, q, k_cache, bkv=bkv, window=window,
                         k_scale=k_scale)
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
    cfg = resolve_verify(cfg, q, k_pool, block_table, window=window,
                         k_scale=k_scale)
    return _decode.verify_attention(q, k_pool, v_pool, block_table, pos0,
                                    cfg, window=window, scale=scale,
                                    k_scale=k_scale, v_scale=v_scale)


def _bwd_inputs(o, g):
    """The backward kernels' dO and delta = sum(g * o) (f32, the
    reference's :235) from the cotangent, by one `flash_bwd_prep` pass.
    The kernels read dO in bf16; the CPU plain paths keep the float32
    cotangent, as the reference's kernels take it."""
    g = g.float().contiguous()
    do, delta = _flash.flash_bwd_prep(o, g)
    return (do if g.is_cuda else g), delta


class _FlashAttention(torch.autograd.Function):
    """`repro/kernels/ops.py:183-241` `_flash_vjp_fn`: the forward runs the
    residual kernel and saves (q, k, v, o, m, l); the backward takes the
    float32 cotangent through one prep pass (delta = sum(g * o) in float32,
    :235, and dO in bf16, `_bwd_inputs`), then the dQ kernel with the
    forward's ``cfg`` and the dK/dV kernel with ``bwd_cfg``, and casts each
    gradient to its input's type (:238)."""

    @staticmethod
    def forward(ctx, q, k, v, cfg, bwd_cfg, kw):
        o, m, l = _flash.flash_forward(q, k, v, cfg, residuals=True, **kw)
        ctx.save_for_backward(q, k, v, o, m, l)
        ctx.cfg, ctx.bwd_cfg, ctx.kw = cfg, bwd_cfg, kw
        return o

    @staticmethod
    def backward(ctx, g):
        q, k, v, o, m, l = ctx.saved_tensors
        do, delta = _bwd_inputs(o, g)
        dq = _flash.flash_bwd_dq(q, k, v, do, m, l, delta, ctx.cfg, **ctx.kw)
        dk, dv = _flash.flash_bwd_dkv(q, k, v, do, m, l, delta, ctx.bwd_cfg,
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
    the forward kernel without residuals (:197-200) and never resolves
    ``bwd_cfg`` (no ``flash_attention_bwd`` key is filed, :270-277)."""
    key = dict(bq=bq, bkv=bkv, causal=causal)
    cfg = resolve_flash(cfg, q, k, **key)
    kw = dict(bq=bq, bkv=bkv, causal=causal, window=window, scale=scale)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        bwd_cfg = resolve_flash("auto" if bwd_cfg is None else bwd_cfg, q, k,
                                **key, bwd=True)
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
        if gs:
            g = g.float()
            with torch.enable_grad():
                qkv = [t.detach().requires_grad_() for t in (q, k, v)]
                o_ref = ref.sparse_attention(
                    *qkv, causal=kw["causal"], window=kw["window"],
                    global_stride=gs, scale=kw["scale"])
                dq, dk, dv = torch.autograd.grad(o_ref, qkv, g)
        else:
            do, delta = _bwd_inputs(o, g)
            dq = _flash.flash_bwd_dq(q, k, v, do, m, l, delta, BASE, **kw)
            dk, dv = _flash.flash_bwd_dkv(q, k, v, do, m, l, delta,
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
    key = dict(bq=bq, bkv=bkv, causal=causal)
    cfg = resolve_flash_sparse(cfg, q, k, **key, window=window,
                               global_stride=global_stride)
    idx = _sparse.device_index(q.shape[2], k.shape[2], bq, bkv,
                               causal=causal, window=window,
                               global_stride=global_stride, device=q.device)
    kw = dict(bq=bq, bkv=bkv, causal=causal, window=window, scale=scale)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        # a global-stride backward differentiates the plain oracle, so
        # only the dense backward files a flash_attention_bwd key (:338)
        if not global_stride:
            bwd_cfg = resolve_flash("auto" if bwd_cfg is None else bwd_cfg,
                                    q, k, **key, bwd=True)
        return _FlashSparse.apply(q, k, v, idx, cfg, bwd_cfg,
                                  dict(kw, global_stride=global_stride))
    return _sparse.flash_sparse_fwd(q, k, v, idx, cfg,
                                    global_stride=global_stride, **kw)


def embed_gather(ids, table, cfg: CoarseningConfig | str = BASE, *,
                 block: int = _embed.BLOCK):
    """``out[i, :] = table[ids[i], :]`` as float32 (`repro/kernels/ops.py:
    657-663`): ids (N,) int32, table (V, d) float32 or bf16 -> (N, d)
    float32, the id stream coarsened by ``plan_stream(N, cfg, block)``."""
    _check_no_grad("ops.embed_gather", table)
    cfg = resolve_cfg(cfg, "embed_gather",
                      (ids.shape[0], table.shape[0], table.shape[1]),
                      dtype=dtype_name(table), backend=backend_of(table),
                      block=block)
    return _embed.embed_gather(ids, table, cfg, block=block)


def ssd(x, dt, a, bmat, cmat, cfg: CoarseningConfig | str = BASE, *,
        chunk: int = 64):
    """Mamba-2 chunked SSD (`repro/kernels/ops.py:640`): x (B,H,S,P), dt
    (B,H,S), a (H,), bmat and cmat (B,G,S,N), float32 -> (B,H,S,P) float32,
    coarsened over heads.  On CPU tensors the plain version runs in the
    reference's (B,S,H,P) layout, transposed in and out."""
    _check_no_grad("ops.ssd", x, dt, a, bmat, cmat)
    b, h, s, p = x.shape
    g, n = bmat.shape[1], bmat.shape[3]
    cfg = resolve_cfg(cfg, "ssd", (b, h, g, s, p, n), dtype=dtype_name(x),
                      backend=backend_of(x), chunk=chunk)
    return _ssd.make_kernel(b, h, g, s, p, n, cfg, chunk=chunk)(
        x, dt, a, bmat, cmat)


def rglru(x, r, i, a_param, cfg: CoarseningConfig | str = BASE, *,
          block_d: int = 128, block_t: int = 64):
    """RG-LRU recurrence (`repro/kernels/ops.py:675`): x, r, i (B,S,D) and
    a_param (D,) float32 -> h (B,S,D) float32, coarsened over channels."""
    _check_no_grad("ops.rglru", x, r, i, a_param)
    b, s, d = x.shape
    cfg = resolve_cfg(cfg, "rglru", (b, s, d), dtype=dtype_name(x),
                      backend=backend_of(x), block_d=block_d,
                      block_t=block_t)
    return _rglru.make_kernel(b, s, d, cfg, block_d=block_d,
                              block_t=block_t)(x, r, i, a_param)
