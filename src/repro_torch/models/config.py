"""Unified model configuration covering all 10 assigned architectures.

A copy of `repro.models.config` (pure Python, no JAX), kept field for field
so a `ModelConfig` means the same thing in both packages."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

# layer kinds for layer_pattern
ATTN_GLOBAL = "G"        # full (causal) attention
ATTN_LOCAL = "L"         # sliding-window attention
RECURRENT = "R"          # RG-LRU recurrent block
SSM = "S"                # Mamba-2 SSD block


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                       # dense|moe|hybrid|ssm|encdec-audio|vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int

    head_dim: Optional[int] = None    # default d_model // n_heads
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 10000.0
    mrope_sections: Optional[Tuple[int, ...]] = None   # qwen2-vl M-RoPE

    # layer pattern: period repeated; remainder truncated from the left of a
    # final partial period.  None -> all ATTN_GLOBAL.
    pattern_period: Optional[Tuple[str, ...]] = None
    window: Optional[int] = None      # local attention window

    # MoE
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    # §Perf lever: dtype of the expert combine — the EP psum wire on the
    # shardmap path AND the combine-scatter accumulator on the single-shard
    # path (bf16 halves both at negligible quality cost — the contributions
    # are already bf16 activations upcast for the scatter)
    moe_combine_dtype: str = "float32"
    # expert-FFN kernel dispatch: "ref" = three per-expert einsums (the
    # CPU/test oracle path), "pallas" = fused grouped-expert kernel
    # (kernels/moe_ffn.py) with the EXPERT axis as the coarsening axis;
    # moe_ffn_cfg is a coarsening spec label or "auto" (repro.tune).
    # Geometries the kernel can't tile fall back to the einsum path;
    # shared experts stay on the dense ffn() path.
    moe_backend: str = "ref"
    moe_ffn_cfg: str = "auto"

    # SSM (mamba2)
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_groups: int = 1
    conv_width: int = 4
    expand: int = 2

    # recurrent (rg-lru)
    lru_width: Optional[int] = None

    # enc-dec
    is_encdec: bool = False
    n_enc_layers: int = 0

    # modality frontend stub: inputs include precomputed embeddings
    frontend: Optional[str] = None    # 'vision' | 'audio'

    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    compute_dtype: str = "bfloat16"

    # decode-attention kernel dispatch: "ref" = dense full-length einsum (the
    # CPU/test path), "pallas" = coarsened split-KV kernel (kernels/
    # decode_attention.py); decode_attn_cfg is a coarsening spec label or
    # "auto" (repro.tune); decode_bkv is the kv block row count.
    decode_backend: str = "ref"
    decode_attn_cfg: str = "auto"
    decode_bkv: int = 128

    # dense-FFN matmul dispatch: every ffn() gate/up/down matmul routes
    # through ops.matmul with this backend ("ref" = dtype-preserving
    # passthrough for CPU training; "pallas" = the coarsenable blocked
    # kernel, cfg="auto" through repro.tune)
    ffn_backend: str = "ref"

    # training/prefill attention dispatch: "ref" = the pure-jnp chunked
    # mea_attention (the CPU/test oracle), "pallas" = the coarsened flash
    # kernel with a custom VJP (kernels/flash_attention.py).  attn_cfg
    # coarsens the FORWARD (and the backward dQ pass) on the q-row axis;
    # attn_bwd_cfg coarsens the backward dK/dV pass on the kv-block axis —
    # independent degrees, since the two passes stream different axes.
    # Both accept a spec label or "auto" (repro.tune).  Ragged q_pos /
    # k_len / untileable geometries fall back to mea_attention.
    attn_backend: str = "ref"
    attn_cfg: str = "auto"
    attn_bwd_cfg: str = "auto"
    attn_bq: int = 128
    attn_bkv: int = 128

    # block-sparse long-context prefill (kernels/sparse_attention.py): when
    # attn_backend="pallas" and a layer has a window (ATTN_LOCAL), "auto"
    # routes eligible geometries to the block-sparse kernel — each q-block
    # program walks only the kv blocks named by a precomputed live index,
    # coarsened over the live-slot axis by attn_sparse_cfg (spec label or
    # "auto" through the flash_attention_sparse tuner family).  "off" pins
    # the dense-mask kernel.  attn_global_stride=g additionally keeps every
    # g-th kv position visible past the window on local layers
    # (LongFormer-style global columns; needs window; training through a
    # strided pattern differentiates the jnp oracle — dense cost).
    attn_sparse: str = "auto"
    attn_sparse_cfg: str = "auto"
    attn_global_stride: Optional[int] = None

    # weight-only quantization (repro.quant): "none" | "int8" (per-channel
    # symmetric) | "int4" (group-wise, quant_group rows per scale).  The
    # field records the format `quantize_params` applied to this model's
    # FFN / MoE-expert / attention-projection weights; dispatch then uses
    # the dequant-fused kernels where the backend+geometry allow and the
    # dense-dequant fallback (the parity oracle) everywhere else.
    quant: str = "none"
    quant_group: int = 32
    # KV-cache quantization: "none" | "int8" — int8 caches store an int8
    # payload plus per-(token, kv-head) f32 scales, quantize on append
    # (decode and prefill) and dequantize fused inside the split-KV kernel
    # (or densely on the ref path).  Halves the decode hot path's dominant
    # traffic AND the bytes that bound slots*max_len per host.
    kv_quant: str = "none"

    # ---- derived ----
    @property
    def vocab_padded(self) -> int:
        """Embedding/logits rows padded to 256 (Megatron-style) so the vocab
        axis always shards evenly on the TP axis; the loss and decode mask
        the pad ids."""
        return ((self.vocab + 255) // 256) * 256

    @property
    def n_experts_padded(self) -> int:
        """Expert axis padded to 16 (the production TP degree) so expert
        parameters shard exactly; pad experts receive -inf router logits."""
        return ((self.n_experts + 15) // 16) * 16 if self.n_experts else 0

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // max(1, self.n_heads)

    @property
    def d_inner(self) -> int:          # mamba2 inner width
        return self.expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_headdim

    @property
    def d_rnn(self) -> int:
        return self.lru_width or self.d_model

    def layer_kinds(self) -> Tuple[str, ...]:
        if self.pattern_period is None:
            return (ATTN_GLOBAL,) * self.n_layers
        p = self.pattern_period
        kinds = []
        while len(kinds) < self.n_layers:
            kinds.extend(p)
        return tuple(kinds[: self.n_layers])

    @property
    def is_subquadratic(self) -> bool:
        """Eligible for the long_500k cell (SSM / hybrid / windowed)."""
        kinds = self.layer_kinds()
        return all(k != ATTN_GLOBAL for k in kinds) or (
            sum(k == ATTN_GLOBAL for k in kinds) <= len(kinds) // 5
        )

    def param_count(self) -> int:
        """Approximate parameter count (embeddings + blocks)."""
        d, hd = self.d_model, self.hd
        n_q, n_kv = self.n_heads, self.n_kv_heads
        emb = self.vocab * d * (1 if self.tie_embeddings else 2)
        per_attn = d * (n_q * hd) + 2 * d * (n_kv * hd) + (n_q * hd) * d
        per_ffn = 3 * d * self.d_ff
        per_moe = (self.n_experts + self.n_shared_experts) * 3 * d * self.moe_d_ff \
            + d * self.n_experts
        per_rnn = 2 * d * self.d_rnn + self.d_rnn * d + 3 * self.d_rnn
        din = self.d_inner
        per_ssm = d * (2 * din + 2 * self.ssm_groups * self.ssm_state
                       + self.ssm_heads) + din * d + 2 * din
        total = emb
        for kind in self.layer_kinds():
            if kind in (ATTN_GLOBAL, ATTN_LOCAL):
                total += per_attn
            elif kind == RECURRENT:
                total += per_rnn
            elif kind == SSM:
                total += per_ssm
            if kind == SSM:
                pass                      # mamba blocks have no separate FFN
            elif self.n_experts:
                total += per_moe
            else:
                total += per_ffn
            total += 2 * d                # norms
        if self.is_encdec:
            # encoder layers (self-attn + ffn) + decoder cross-attn
            total += self.n_enc_layers * (per_attn + per_ffn + 2 * d)
            total += self.n_layers * (per_attn + d)
        return total

    def active_param_count(self) -> int:
        """Active params per token (MoE: only routed experts)."""
        if not self.n_experts:
            return self.param_count()
        d = self.d_model
        dense = self.param_count() - self.n_layers * (
            self.n_experts * 3 * d * self.moe_d_ff)
        active_moe = self.n_layers * (self.top_k * 3 * d * self.moe_d_ff)
        return dense + active_moe

    def reduced(self, **overrides) -> "ModelConfig":
        """Tiny same-family config for CPU smoke tests."""
        shrink = dict(
            n_layers=min(self.n_layers, 4 if self.pattern_period is None
                         else 2 * len(self.pattern_period)),
            d_model=128,
            n_heads=max(2, min(4, self.n_heads)),
            n_kv_heads=1 if self.n_kv_heads < self.n_heads else 2,
            d_ff=256,
            vocab=512,
            head_dim=32,
        )
        if self.n_experts:
            shrink.update(n_experts=8, top_k=min(2, self.top_k),
                          moe_d_ff=64,
                          n_shared_experts=min(1, self.n_shared_experts))
        if self.ssm_state:
            shrink.update(ssm_state=16, ssm_headdim=32)
        if self.window:
            shrink.update(window=16)
        if self.is_encdec:
            shrink.update(n_enc_layers=2)
        if self.lru_width:
            shrink.update(lru_width=128)
        if self.mrope_sections:
            # scale sections to the reduced head_dim (pairs must sum to hd/2)
            pairs = shrink["head_dim"] // 2
            tot = sum(self.mrope_sections)
            sec = [max(1, s * pairs // tot) for s in self.mrope_sections]
            sec[0] += pairs - sum(sec)
            shrink.update(mrope_sections=tuple(sec))
        shrink.update(overrides)
        kv = {f.name: getattr(self, f.name) for f in dataclasses.fields(self)}
        kv.update(shrink)
        # keep GQA divisibility
        if kv["n_heads"] % kv["n_kv_heads"]:
            kv["n_kv_heads"] = 1
        return ModelConfig(**kv)
