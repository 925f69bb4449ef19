"""Paged-KV serving: page pool + block tables, the paged engine and the
FCFS + preemption scheduler (mirrors `repro.serve`)."""
from repro_torch.serve.engine import PagedEngine
from repro_torch.serve.paging import (NULL_PAGE, BlockTables, DecodeFault,
                                      PagePool, PoolExhausted, SwapStore,
                                      pages_needed)
from repro_torch.serve.scheduler import Request, Scheduler, State

__all__ = ["NULL_PAGE", "BlockTables", "DecodeFault", "PagePool",
           "PoolExhausted", "PagedEngine", "Request", "Scheduler", "State",
           "SwapStore", "pages_needed"]
