"""AdamW with decoupled weight decay and global-norm clipping, on trees of
tensors.  Mirrors `repro/optim/adamw.py`: `AdamWConfig` (:17),
`adamw_init` (:26), `clip_by_global_norm` (:34) and `adamw_update` (:42).

The reference is functional: `adamw_update` returns new parameters and a
new state.  Here `adamw_update` writes the new parameters, ``m`` and ``v``
IN PLACE (under ``torch.no_grad()``), so a step holds no second copy of
the model and its state, and returns the same tensors.  The arithmetic
is the reference's, in float32: bias correction from the integer step
counter, clipping by the global float32 norm, weight decay decoupled from
the adaptive step.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.tree import leaves, map_tree


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


def adamw_init(params) -> dict:
    """Zero first and second moments shaped like ``params`` and an int32
    step counter, on the parameters' device."""
    def zeros(p):
        return torch.zeros_like(p, dtype=torch.float32)

    return {"m": map_tree(zeros, params), "v": map_tree(zeros, params),
            "step": torch.zeros((), dtype=torch.int32,
                                device=leaves(params)[0].device)}


def clip_by_global_norm(grads, max_norm: float):
    """-> (grads scaled by min(1, max_norm / (norm + 1e-9)), the float32
    global norm)."""
    gn = torch.sqrt(sum(g.float().square().sum() for g in leaves(grads)))
    scale = torch.clamp(max_norm / (gn + 1e-9), max=1.0)
    return map_tree(lambda g: g * scale, grads), gn


@torch.no_grad()
def adamw_update(params, grads, state: dict, cfg: AdamWConfig):
    """One AdamW step -> (params, state, global grad norm).  ``params``,
    ``state["m"]`` and ``state["v"]`` are updated in place; ``step`` is
    replaced by step + 1."""
    grads, gn = clip_by_global_norm(grads, cfg.clip_norm)
    step = state["step"] + 1
    t = step.float()
    b1c = 1.0 - torch.tensor(cfg.b1, dtype=torch.float32,
                             device=t.device) ** t
    b2c = 1.0 - torch.tensor(cfg.b2, dtype=torch.float32,
                             device=t.device) ** t
    for p, g, m, v in zip(leaves(params), leaves(grads), leaves(state["m"]),
                          leaves(state["v"])):
        g = g.float()
        m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
        v.mul_(cfg.b2).add_((1 - cfg.b2) * g.square())
        upd = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps) \
            + cfg.weight_decay * p.float()
        p.copy_((p.float() - cfg.lr * upd).to(p.dtype))
    state["step"] = step
    return params, state, gn
