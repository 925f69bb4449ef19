"""Optimizer substrate of training: AdamW with global-norm clipping, and
microbatch gradient accumulation (mirrors `repro.optim`)."""
from repro_torch.optim.accumulate import accumulate_grads
from repro_torch.optim.adamw import (AdamWConfig, adamw_init, adamw_update,
                                     clip_by_global_norm)

__all__ = ["AdamWConfig", "accumulate_grads", "adamw_init", "adamw_update",
           "clip_by_global_norm"]
