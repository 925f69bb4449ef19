"""The paper's coarsening configuration (labels and kinds) and its stream
and row plans."""
from repro_torch.core.coarsening import (BASE, KIND_CONSECUTIVE, KIND_GAPPED,
                                         KIND_NONE, KINDS, CoarseningConfig,
                                         resolve)

__all__ = ["BASE", "KIND_CONSECUTIVE", "KIND_GAPPED", "KIND_NONE", "KINDS",
           "CoarseningConfig", "resolve"]
