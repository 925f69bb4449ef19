"""Paged-KV serving: page pool + block tables, the paged engine, its
speculative twin and the FCFS + preemption scheduler (mirrors
`repro.serve`)."""
from repro_torch.serve.engine import PagedEngine
from repro_torch.serve.paging import (NULL_PAGE, BlockTables, DecodeFault,
                                      PagePool, PoolExhausted, SwapStore,
                                      pages_needed)
from repro_torch.serve.scheduler import Request, Scheduler, State
from repro_torch.serve.spec import SpecPagedEngine, draft_of

__all__ = ["NULL_PAGE", "BlockTables", "DecodeFault", "PagePool",
           "PoolExhausted", "PagedEngine", "Request", "Scheduler",
           "SpecPagedEngine", "State", "SwapStore", "draft_of",
           "pages_needed"]
