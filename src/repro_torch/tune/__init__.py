"""repro_torch.tune — the coarsening autotuner (`repro/tune/`).

`search` enumerates the labels each kernel family takes at a spec's
geometry and ranks them by the H100 bound (the same for every label, so
base first) or by measurement on the card; `autotune` persists winners to
a versioned JSON cache; `warm_for_model` fills the cache for a model's
kernels before a run; and `repro_torch.kernels.ops.resolve_cfg` resolves
``cfg="auto"`` through it.
"""
from repro_torch.tune.cache import (CACHE_VERSION, ENV_VAR, KernelSpec,
                                    TuningCache, default_cache,
                                    default_cache_path)
from repro_torch.tune.search import (Candidate, NoCandidate, TuneResult,
                                     autotune, enumerate_candidates,
                                     model_cost, search)
from repro_torch.tune.warm import (TUNE_CHOICES, tune_report, wall_measurer,
                                   warm_for_model, warm_from_flag)

__all__ = [
    "CACHE_VERSION", "ENV_VAR", "KernelSpec", "TuningCache",
    "default_cache", "default_cache_path",
    "Candidate", "NoCandidate", "TuneResult", "autotune",
    "enumerate_candidates", "model_cost", "search", "TUNE_CHOICES",
    "tune_report", "wall_measurer", "warm_for_model", "warm_from_flag",
]
