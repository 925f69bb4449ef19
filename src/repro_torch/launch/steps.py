"""The training step (mirrors `repro/launch/steps.py` `StepConfig` :26 and
`build_train_step` :73-101, without a mesh): accumulate gradients over
``n_micro`` microbatches of `model.lm_loss`, then one AdamW update.  The
update writes the parameters and the optimizer state in place (see
`optim.adamw`); the step still returns them, as the reference does."""
from __future__ import annotations

import dataclasses

from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig
from repro_torch.optim import AdamWConfig, accumulate_grads, adamw_update


@dataclasses.dataclass(frozen=True)
class StepConfig:
    seq: int
    batch: int                   # global batch (rows)
    n_micro: int = 1
    remat: str = "none"
    opt: AdamWConfig = AdamWConfig()


def build_train_step(cfg: ModelConfig, sc: StepConfig):
    """-> train_step(params, opt_state, batch) -> (params, opt_state,
    loss, grad norm); every parameter must require grad."""

    def train_step(params, opt_state, batch):
        def loss_fn(p, b):
            return M.lm_loss(p, b, cfg, remat=sc.remat)

        loss, grads, _ = accumulate_grads(loss_fn, params, batch, sc.n_micro)
        params, opt_state, gn = adamw_update(params, grads, opt_state, sc.opt)
        return params, opt_state, loss, gn

    return train_step
