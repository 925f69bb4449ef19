"""Deterministic, checkpointable synthetic token pipeline (mirrors
`repro/data/pipeline.py`: `DataConfig` :22, `TokenPipeline` :36).

The stream is numpy's, exactly the reference's: each batch is drawn from
``SeedSequence([seed, step, row0, length])`` — Zipf(1.3) draws folded into
[1, vocab-2], and a copy motif every 16 tokens (the second half of each
motif repeats the first half shifted by +1) — so the pipeline state is
(seed, step) and a restart reproduces the stream.  Only the token stream
is ported (no modality frontends).
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Optional

import numpy as np
import torch


@dataclasses.dataclass
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 1234
    # this host produces batch rows [row_start, row_start + rows)
    row_start: int = 0
    rows: Optional[int] = None          # default: all rows


class TokenPipeline:
    """state = (seed, step); fully deterministic.  Batches are int64
    tensors on ``device`` (host memory unless the caller passes one)."""

    def __init__(self, cfg: DataConfig, step: int = 0, *, device="cpu"):
        self.cfg = cfg
        self.step = step
        self.device = torch.device(device)

    def state_dict(self) -> dict:
        return {"seed": self.cfg.seed, "step": self.step}

    def load_state_dict(self, st: dict) -> None:
        if st["seed"] != self.cfg.seed:
            raise ValueError("stream identity changed: checkpoint seed "
                             f"{st['seed']} vs {self.cfg.seed}")
        self.step = int(st["step"])

    def _tokens(self, step: int, rows: int, row0: int,
                length: int) -> np.ndarray:
        cfg = self.cfg
        rng = np.random.default_rng(
            np.random.SeedSequence([cfg.seed, step, row0, length]))
        base = rng.zipf(1.3, size=(rows, length)).astype(np.int64)
        toks = (base % (cfg.vocab - 2)) + 1
        period = 16
        half = period // 2
        full = (length // period) * period
        view = toks[:, :full].reshape(rows, -1, period)
        view[:, :, half:] = (view[:, :, :half] + 1) % (cfg.vocab - 2) + 1
        return toks

    def next_batch(self) -> dict:
        """{"tokens", "labels"} (rows, seq_len) int64; advances the step."""
        cfg = self.cfg
        rows = cfg.rows or cfg.global_batch
        toks = torch.from_numpy(
            self._tokens(self.step, rows, cfg.row_start, cfg.seq_len + 1))
        self.step += 1
        return {"tokens": toks[:, :-1].to(self.device),
                "labels": toks[:, 1:].to(self.device)}

    def __iter__(self) -> Iterator[dict]:
        while True:
            yield self.next_batch()
