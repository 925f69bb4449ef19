"""Microbatch gradient accumulation (mirrors `repro/optim/accumulate.py`
`accumulate_grads`, :14).  The reference's ``lax.scan`` over microbatches
is a Python loop; gradients come from ``torch.autograd.grad``."""
from __future__ import annotations

import torch

from repro_torch.core.tree import leaves, map_tree, unflatten


def _grads(loss_fn, params, batch):
    loss, metrics = loss_fn(params, batch)
    ps = leaves(params)
    gs = torch.autograd.grad(loss, ps, allow_unused=True)
    gs = [torch.zeros_like(p) if g is None else g for p, g in zip(ps, gs)]
    return loss.detach(), unflatten(params, gs), metrics


def accumulate_grads(loss_fn, params, batch: dict, n_micro: int):
    """``loss_fn(params, microbatch) -> (loss, metrics)``; every parameter
    must require grad.  Batch leaves have leading dim B = n_micro *
    b_micro.  -> (mean loss, summed-then-averaged float32 grads, metrics
    of the last microbatch)."""
    if n_micro <= 1:
        return _grads(loss_fn, params, batch)
    micro = {k: v.chunk(n_micro, dim=0) for k, v in batch.items()}
    if any(len(v) != n_micro or v[0].shape[0] * n_micro != batch[k].shape[0]
           for k, v in micro.items()):
        raise ValueError(f"batch rows do not split into {n_micro} "
                         f"microbatches")
    loss_sum = torch.zeros((), dtype=torch.float32)
    grads_sum = map_tree(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                               device=p.device), params)
    for i in range(n_micro):
        loss, grads, metrics = _grads(loss_fn, params,
                                      {k: v[i] for k, v in micro.items()})
        grads_sum = map_tree(torch.add, grads_sum, grads)
        loss_sum = loss_sum.to(loss.device) + loss
    inv = 1.0 / n_micro
    return loss_sum * inv, map_tree(lambda g: g * inv, grads_sum), metrics
