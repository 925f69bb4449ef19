"""Runtime substrate of training: step watchdog, preemption handling and
bounded retry.  The port's own copies of the reference's pure-Python
`repro/runtime` modules (`watchdog.py` StepWatchdog :16, `preemption.py`
PreemptionHandler :14, `retry.py` retry_step and SimulatedFailure
:15-33); `elastic.py` needs a mesh and is not ported."""
from repro_torch.runtime.preemption import PreemptionHandler
from repro_torch.runtime.retry import SimulatedFailure, retry_step
from repro_torch.runtime.watchdog import StepWatchdog

__all__ = ["PreemptionHandler", "SimulatedFailure", "StepWatchdog",
           "retry_step"]
