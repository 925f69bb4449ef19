"""Carry `repro` parameters into the port.

`repro.models.model.lm_init` returns a nested dict of arrays whose block
leaves carry a leading ``n_periods`` axis (`jax.vmap` over the layers of
one pattern position, `repro/models/model.py:115-119`) plus unstacked
``tail`` layers.  `params_from_numpy` takes that tree as numpy arrays and
returns the port's layout: a plain dict of tensors, one dict per layer.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.device import resolve_device
from repro_torch.models.config import ModelConfig

# leaves kept in float32 whatever the weight dtype: RMSNorm scales, which
# the reference applies in float32 (`repro/models/layers.py:87-92`)
_F32_LEAVES = ("scale",)


def _tensor(a, name: str, device, dtype) -> torch.Tensor:
    # np.array(..., float32, copy=True) accepts ml_dtypes.bfloat16 (which
    # torch.from_numpy rejects) and read-only views of JAX arrays
    arr = np.array(a, dtype=np.float32, copy=True)
    dt = torch.float32 if name in _F32_LEAVES else dtype
    return torch.from_numpy(arr).to(device=device, dtype=dt)


def _flatten(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flatten(v, prefix + (k,))
    else:
        yield prefix, tree


def _nest(items):
    out: dict = {}
    for path, v in items:
        d = out
        for k in path[:-1]:
            d = d.setdefault(k, {})
        d[path[-1]] = v
    return out


def layer_leaves(cfg: ModelConfig) -> set:
    """Dotted leaf names of one attention + dense-FFN (or MoE) layer of
    ``cfg``: an MoE layer has ``moe.router``, ``moe.w1`` / ``w3`` / ``w2``
    of shape (E_pad, ., .), and with shared experts ``moe.shared.*`` and
    ``moe.shared_gate``."""
    names = {"ln1.scale", "ln2.scale", "attn.wq", "attn.wk", "attn.wv",
             "attn.wo"}
    if cfg.n_experts:
        names |= {"moe.router", "moe.w1", "moe.w3", "moe.w2"}
        if cfg.n_shared_experts:
            names |= {"moe.shared.w1", "moe.shared.w3", "moe.shared.w2",
                      "moe.shared_gate"}
    else:
        names |= {"ffn.w1", "ffn.w3", "ffn.w2"}
    if cfg.qkv_bias:
        names |= {"attn.bq", "attn.bk", "attn.bv"}
    if cfg.qk_norm:
        names |= {"attn.qnorm.scale", "attn.knorm.scale"}
    return names


def _check_layer(leaves, cfg: ModelConfig) -> None:
    got = {".".join(path) for path, _ in leaves}
    want = layer_leaves(cfg)
    if got != want:
        raise ValueError(f"layer leaves differ from an attention + "
                         f"{'MoE' if cfg.n_experts else 'dense-FFN'} layer: "
                         f"unconsumed {sorted(got - want)}, missing "
                         f"{sorted(want - got)}")


def _period(cfg: ModelConfig):
    period = cfg.pattern_period or ("G",)
    n_periods = cfg.n_layers // len(period)
    return tuple(period), n_periods


def params_from_numpy(tree, cfg: ModelConfig, device=None,
                      dtype=torch.bfloat16) -> dict:
    """The port's parameters from `repro`'s tree of numpy (or JAX) arrays.

    Returns ``{"embed", "final_norm": {"scale"}, "layers": [...]}`` (plus
    ``"lm_head"`` when embeddings are untied), each layer a nested dict of
    tensors with the reference's leaf names.  Matmul weights, biases and
    the embedding are cast to ``dtype``; RMSNorm scales stay float32.
    Every leaf of ``tree`` must be consumed: an unknown leaf raises.
    Tensors land on ``cuda`` unless ``device="cpu"``.
    """
    if cfg.is_encdec or any(k not in ("G", "L") for k in cfg.layer_kinds()):
        raise NotImplementedError(f"{cfg.name}: only attention + FFN / MoE "
                                  f"decoders are ported yet")
    device = resolve_device(device)
    period, n_periods = _period(cfg)
    top = set(tree) - {"embed", "final_norm", "blocks", "tail", "lm_head"}
    if top:
        raise ValueError(f"unconsumed parameter leaves: {sorted(top)}")
    if ("lm_head" in tree) == bool(cfg.tie_embeddings):
        raise ValueError("lm_head presence disagrees with tie_embeddings")
    out = {
        "embed": _tensor(tree["embed"], "embed", device, dtype),
        "final_norm": {"scale": _tensor(tree["final_norm"]["scale"], "scale",
                                        device, dtype)},
    }
    if "lm_head" in tree:
        out["lm_head"] = _tensor(tree["lm_head"], "lm_head", device, dtype)
    if len(tree["blocks"]) != len(period):
        raise ValueError(f"{len(tree['blocks'])} stacked block groups for a "
                         f"period of {len(period)}")
    layers: list = [None] * cfg.n_layers
    for j, blk in enumerate(tree["blocks"]):
        leaves = list(_flatten(blk))
        _check_layer(leaves, cfg)
        for n in range(n_periods):
            layers[n * len(period) + j] = _nest(
                (path, _tensor(np.asarray(a)[n], path[-1], device, dtype))
                for path, a in leaves)
    base = n_periods * len(period)
    if base + len(tree["tail"]) != cfg.n_layers:
        raise ValueError(f"{base} stacked + {len(tree['tail'])} tail layers "
                         f"for n_layers={cfg.n_layers}")
    for j, blk in enumerate(tree["tail"]):
        leaves = list(_flatten(blk))
        _check_layer(leaves, cfg)
        layers[base + j] = _nest((path, _tensor(a, path[-1], device, dtype))
                                 for path, a in leaves)
    out["layers"] = layers
    return out
