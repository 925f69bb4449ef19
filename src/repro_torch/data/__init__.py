"""Deterministic synthetic token data for training (mirrors `repro.data`)."""
from repro_torch.data.pipeline import DataConfig, TokenPipeline

__all__ = ["DataConfig", "TokenPipeline"]
