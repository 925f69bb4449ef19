"""Global KV page pool + per-slot block tables (vLLM-style paging).

Host-side bookkeeping only (numpy, no tensors): a line-for-line copy of
`repro.serve.paging`, so both engines allocate pages identically.

The contiguous cache charges every slot ``max_len`` rows up front, so host
capacity is ``slots * max_len`` regardless of how long requests actually
are.  Paging splits the cache row axis into fixed-size pages owned by a
single global pool; a slot holds an ordered *block table* of page ids and
only ever pays for the pages its live prefix touches.  The split-KV decode
kernel's *gapped* coarsening already fetches strided KV panes — a page
gather is the same access pattern with the stride replaced by a table
lookup, which is exactly how ``kernels/decode_attention.paged_decode_attention``
consumes the tables this module manages.

Page 0 is the NULL page: it is never allocated, every device block table is
padded with it, and the model's scatter paths route inactive slots' writes
to it — garbage lands there instead of corrupting live pages, replacing the
``jnp.where`` slot-mask over the whole cache that the contiguous path needs.

Refcounting serves shared prefixes (common system prompts): a page whose
refcount exceeds one is frozen (read-only by convention — writers always
append past the shared boundary) and is returned to the free list only when
the last holder releases it.

Invariants (executable in tests/test_paging.py):
  * a writable page (refcount == 1) appears in at most one block table
  * free pages + live pages == num_pages - 1 (the null page is neither)
  * a shared page is freed exactly when its refcount reaches zero
  * any admit/decode/finish/preempt sequence conserves pages (no leaks)
"""
from __future__ import annotations

import numpy as np

NULL_PAGE = 0


class PoolExhausted(RuntimeError):
    """Raised when an allocation cannot be served; the scheduler reacts by
    evicting a running request (host-swap or requeue-with-cache-drop)
    rather than crashing the server."""


class DecodeFault(RuntimeError):
    """A transient decode-step failure: when this raises, no generation
    cursor has advanced and the pool is consistent (pages grown for the
    aborted step stay accounted in their tables — same contract as
    PoolExhausted mid-growth), so the scheduler can simply retry the
    quantum.  Raised by the fault-injection harness of the reference package
    and by the engine itself when the NaN-logit guard exhausts its rescue
    retries."""


def pages_needed(n_tokens: int, page_size: int) -> int:
    """Pages covering ``n_tokens`` cache rows."""
    return max(0, -(-n_tokens // page_size))


class PagePool:
    """Free-list page allocator with refcounts.

    Pages are plain ints in [1, num_pages); page 0 (NULL_PAGE) is reserved.
    ``alloc`` pops LIFO from the free list (hot pages stay hot), ``incref``
    shares, ``release`` decrefs and returns pages to the free list at zero.
    """

    def __init__(self, num_pages: int, page_size: int):
        if num_pages < 2:
            raise ValueError("PagePool needs >= 2 pages (page 0 is null)")
        if page_size < 1:
            raise ValueError(f"page_size must be positive, got {page_size}")
        self.num_pages = int(num_pages)
        self.page_size = int(page_size)
        self.refcount = np.zeros(self.num_pages, np.int32)
        self._free = list(range(self.num_pages - 1, 0, -1))  # pop() -> 1 first

    # -- capacity ------------------------------------------------------------

    @property
    def num_free(self) -> int:
        return len(self._free)

    @property
    def num_live(self) -> int:
        return int(np.count_nonzero(self.refcount[1:]))

    @property
    def capacity(self) -> int:
        """Allocatable pages (excludes the null page)."""
        return self.num_pages - 1

    @property
    def tokens_capacity(self) -> int:
        return self.capacity * self.page_size

    # -- alloc / share / release --------------------------------------------

    def alloc(self, n: int) -> list[int]:
        """Pop ``n`` pages with refcount 1 each; raises PoolExhausted (with
        no side effects) when fewer than ``n`` pages are free."""
        if n < 0:
            raise ValueError(f"alloc({n})")
        if n > len(self._free):
            raise PoolExhausted(
                f"need {n} pages, {len(self._free)} free "
                f"of {self.capacity}")
        pages = [self._free.pop() for _ in range(n)]
        for p in pages:
            self.refcount[p] = 1
        return pages

    def incref(self, pages) -> None:
        """Share already-live pages (the shared-prefix admit path)."""
        for p in pages:
            if p == NULL_PAGE or self.refcount[p] <= 0:
                raise ValueError(f"incref of dead page {p}")
            self.refcount[p] += 1

    def release(self, pages) -> None:
        """Decref; a page returns to the free list exactly at refcount 0."""
        for p in pages:
            if p == NULL_PAGE:
                continue
            if self.refcount[p] <= 0:
                raise ValueError(f"double free of page {p}")
            self.refcount[p] -= 1
            if self.refcount[p] == 0:
                self._free.append(p)

    # -- invariant check (the executable spec) ------------------------------

    def check(self) -> None:
        """Raise AssertionError if the pool's bookkeeping is inconsistent."""
        free = set(self._free)
        assert len(free) == len(self._free), "free list holds duplicates"
        assert NULL_PAGE not in free, "null page on the free list"
        for p in free:
            assert self.refcount[p] == 0, f"free page {p} has refs"
        live = {p for p in range(1, self.num_pages) if self.refcount[p] > 0}
        assert free | live == set(range(1, self.num_pages)), \
            "leaked pages: neither free nor live"
        assert not (free & live)


class BlockTables:
    """Per-slot ordered page lists + their padded device image.

    ``append``/``drop`` mutate host state; ``device()`` renders the
    (slots, max_pages) int32 array the kernels consume, with inactive or
    short rows padded by NULL_PAGE so stray writes land on the null page.
    """

    def __init__(self, slots: int, max_pages: int):
        self.slots = int(slots)
        self.max_pages = int(max_pages)
        self.tables: list[list[int]] = [[] for _ in range(self.slots)]

    def __getitem__(self, slot: int) -> list[int]:
        return self.tables[slot]

    def append(self, slot: int, pages) -> None:
        t = self.tables[slot]
        if len(t) + len(pages) > self.max_pages:
            raise PoolExhausted(
                f"slot {slot}: {len(t)}+{len(pages)} pages exceed the "
                f"per-slot table of {self.max_pages}")
        t.extend(int(p) for p in pages)

    def drop(self, slot: int) -> list[int]:
        """Clear a slot's table and hand back the pages it held (the caller
        releases them against the pool)."""
        pages, self.tables[slot] = self.tables[slot], []
        return pages

    def truncate(self, slot: int, n_keep: int) -> list[int]:
        """Shrink a slot's table to its first ``n_keep`` pages and hand back
        the dropped tail (the caller releases it against the pool) — the
        speculative-decode rollback: rejected drafted positions' pages leave
        the table front-to-back intact, so shared-prefix pages (always a
        prefix of the table) are never touched."""
        if n_keep < 0:
            raise ValueError(f"truncate({slot}, {n_keep})")
        t = self.tables[slot]
        tail, self.tables[slot] = t[n_keep:], t[:n_keep]
        return tail

    def num_pages(self, slot: int) -> int:
        return len(self.tables[slot])

    def device(self, active=None) -> np.ndarray:
        """(slots, max_pages) int32, NULL_PAGE-padded.  ``active`` (bool per
        slot) additionally nulls whole rows — the write-protection image the
        prefill path uses so only the admitted slot touches live pages."""
        out = np.full((self.slots, self.max_pages), NULL_PAGE, np.int32)
        for s, t in enumerate(self.tables):
            if active is not None and not active[s]:
                continue
            out[s, : len(t)] = t
        return out

    def owners(self) -> dict[int, list[int]]:
        """page -> slots holding it (test helper for the aliasing invariant)."""
        own: dict[int, list[int]] = {}
        for s, t in enumerate(self.tables):
            for p in t:
                own.setdefault(p, []).append(s)
        return own


class SwapStore:
    """Host-side bookkeeping for swapped-out (suspended) slot state.

    The scheduler's swap-vs-recompute policy is "swap when the suspended
    bytes fit the host budget, recompute otherwise"; this store IS that
    budget.  It never touches device memory — it holds whatever opaque
    suspension object the engine hands back, keyed by request id, and
    accounts bytes against ``budget_bytes`` (None = unbounded).

    Invariant (check()): ``used_bytes`` equals the sum of the stored
    entries' sizes, and never exceeds the budget.

    Counters live in an ``repro_torch.obs`` Registry (``metrics=``, or a private
    one) — the historical ``swapped_out``/``swapped_in``/``dropped``/
    ``refused`` attributes are read-only views over it.
    """

    def __init__(self, budget_bytes: int | None = None, metrics=None):
        if budget_bytes is not None and budget_bytes < 0:
            raise ValueError(f"budget_bytes must be >= 0, got {budget_bytes}")
        if metrics is None:
            from repro_torch.obs import Registry
            metrics = Registry()
        self.budget_bytes = budget_bytes
        self._entries: dict[int, tuple] = {}    # rid -> (susp, nbytes)
        self.metrics = metrics
        self._out = metrics.counter("swap_out_total", "lifetime puts")
        self._in = metrics.counter("swap_in_total", "lifetime pops (resumes)")
        self._drop = metrics.counter("swap_dropped_total",
                                     "cancelled while suspended")
        self._refuse = metrics.counter(
            "swap_refused_total", "policy said recompute (over budget)")
        self._used = metrics.gauge("swap_used_bytes", "host bytes held")
        self._used.set(0)

    @property
    def used_bytes(self) -> int:
        return self._used.value

    @property
    def swapped_out(self) -> int:
        return self._out.value

    @property
    def swapped_in(self) -> int:
        return self._in.value

    @property
    def dropped(self) -> int:
        return self._drop.value

    @property
    def refused(self) -> int:
        return self._refuse.value

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, rid: int) -> bool:
        return rid in self._entries

    def fits(self, nbytes: int) -> bool:
        """Would ``nbytes`` more fit the budget?  A refusal is counted so
        the policy split is observable in serving stats."""
        ok = self.budget_bytes is None \
            or self.used_bytes + nbytes <= self.budget_bytes
        if not ok:
            self._refuse.inc()
        return ok

    def put(self, rid: int, susp, nbytes: int) -> None:
        if rid in self._entries:
            raise ValueError(f"request {rid} is already swapped out")
        self._entries[rid] = (susp, int(nbytes))
        self._used.inc(int(nbytes))
        self._out.inc()

    def peek(self, rid: int):
        """The stored suspension, NOT removed — resume may still fail with
        PoolExhausted, in which case the entry must survive."""
        return self._entries[rid][0]

    def pop(self, rid: int):
        """Remove after a successful resume."""
        susp, nbytes = self._entries.pop(rid)
        self._used.dec(nbytes)
        self._in.inc()
        return susp

    def drop(self, rid: int) -> None:
        """Discard a suspension whose request was cancelled/failed."""
        _, nbytes = self._entries.pop(rid)
        self._used.dec(nbytes)
        self._drop.inc()

    def check(self) -> None:
        assert self.used_bytes == sum(n for _, n in self._entries.values())
        assert self.budget_bytes is None \
            or self.used_bytes <= self.budget_bytes, "swap budget exceeded"
