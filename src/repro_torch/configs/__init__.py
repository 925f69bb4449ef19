"""Architecture registry: --arch <id> resolves here."""
from repro_torch.models.config import ModelConfig

_MODULES = {
    "qwen2-vl-7b": "qwen2_vl_7b",
    "recurrentgemma-2b": "recurrentgemma_2b",
    "yi-34b": "yi_34b",
    "qwen1.5-4b": "qwen15_4b",
    "qwen3-0.6b": "qwen3_06b",
    "gemma3-1b": "gemma3_1b",
    "olmoe-1b-7b": "olmoe_1b_7b",
    "qwen2-moe-a2.7b": "qwen2_moe_a27b",
    "seamless-m4t-large-v2": "seamless_m4t_large_v2",
    "mamba2-370m": "mamba2_370m",
}

ARCHS = tuple(_MODULES)


def get_config(name: str) -> ModelConfig:
    import importlib
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {ARCHS}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")
    return mod.CONFIG


# input shapes assigned to every architecture (seq_len, global_batch, kind)
SHAPES = {
    "train_4k": dict(seq=4096, batch=256, kind="train"),
    "prefill_32k": dict(seq=32768, batch=32, kind="prefill"),
    "decode_32k": dict(seq=32768, batch=128, kind="decode"),
    "long_500k": dict(seq=524288, batch=1, kind="decode"),
}

# baseline gradient-accumulation per arch for train_4k (fit-driven; see
# EXPERIMENTS.md §Perf M2/C5 — the optimized configs lower these with SP)
TRAIN_N_MICRO = {
    "yi-34b": 16,
    "qwen2-vl-7b": 8,
    "qwen1.5-4b": 8,
    "recurrentgemma-2b": 8,
    "qwen2-moe-a2.7b": 8,
    "olmoe-1b-7b": 8,
    "gemma3-1b": 4,
    "qwen3-0.6b": 4,
    "mamba2-370m": 4,
    "seamless-m4t-large-v2": 4,
}
