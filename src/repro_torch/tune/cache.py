"""Versioned JSON persistence of autotuned coarsening configs
(`repro/tune/cache.py`, copied so the port never imports the JAX package).

One cache file holds the winner per (kernel family, shape, dtype, backend,
tuning-relevant params): the analog of keeping the best coarsening triple
per kernel after the paper's sweep, so a launch never pays the search
again.  The layout and `CACHE_VERSION` are the reference's; the file and
its environment variable are the port's own (``REPRO_TORCH_TUNE_CACHE``,
default ``~/.cache/repro_torch/tune_v{CACHE_VERSION}.json``), and every
spec the port files carries ``backend="cuda"``, so a winner tuned for
another device is never read for the card.

A file of another version, or one that does not parse, loads as empty.
"""
from __future__ import annotations

import dataclasses
import json
import os
import tempfile
from typing import Optional

from repro_torch.core.coarsening import CoarseningConfig

# the reference's version (`repro/tune/cache.py:40`), so the two layouts
# stay comparable key for key
CACHE_VERSION = 5
ENV_VAR = "REPRO_TORCH_TUNE_CACHE"


def default_cache_path() -> str:
    env = os.environ.get(ENV_VAR)
    if env:
        return env
    base = os.environ.get("XDG_CACHE_HOME",
                          os.path.join(os.path.expanduser("~"), ".cache"))
    return os.path.join(base, "repro_torch", f"tune_v{CACHE_VERSION}.json")


@dataclasses.dataclass(frozen=True)
class KernelSpec:
    """Identity of one tunable kernel instance (the cache key).

    ``params`` holds only tuning-relevant knobs (block sizes, arithmetic
    intensity, variant, ...) as a sorted tuple of (name, value) pairs, so
    the spec stays hashable and JSON-stable."""

    family: str
    shape: tuple
    dtype: str = "float32"
    backend: str = "cuda"
    params: tuple = ()

    @classmethod
    def make(cls, family: str, shape, dtype: str = "float32",
             backend: str = "cuda", **params) -> "KernelSpec":
        return cls(family=family, shape=tuple(int(s) for s in shape),
                   dtype=str(dtype), backend=backend,
                   params=tuple(sorted(params.items())))

    @property
    def p(self) -> dict:
        return dict(self.params)

    @property
    def key(self) -> str:
        shp = "x".join(str(s) for s in self.shape)
        prm = ",".join(f"{k}={v}" for k, v in self.params)
        return f"{self.family}|{shp}|{self.dtype}|{self.backend}|{prm}"


class TuningCache:
    """Winner-per-spec store with atomic JSON persistence.

    An entry records the chosen label and how it was chosen (``source``
    'model' or 'measured', with the bound and the measured seconds), so a
    later run can tell a bound-ranked prior from a measurement.  Hits and
    misses are counters of an obs `Registry`."""

    def __init__(self, path: Optional[str] = None, autoload: bool = True,
                 metrics=None):
        self.path = path or default_cache_path()
        self.entries: dict[str, dict] = {}
        if metrics is None:
            from repro_torch.obs import Registry
            metrics = Registry()
        self.metrics = metrics
        self._c_hits = metrics.counter("tune_cache_hits_total")
        self._c_misses = metrics.counter("tune_cache_misses_total")
        self._warned_unwritable = False
        if autoload:
            self.load()

    @property
    def stats(self) -> dict:
        return {"hits": self._c_hits.value, "misses": self._c_misses.value}

    def load(self) -> None:
        try:
            with open(self.path) as f:
                blob = json.load(f)
        except (OSError, ValueError):
            return
        if not isinstance(blob, dict) or blob.get("version") != CACHE_VERSION:
            return                      # stale or corrupt: treat as empty
        entries = blob.get("entries", {})
        if isinstance(entries, dict):
            self.entries = dict(entries)

    def save(self) -> None:
        folder = os.path.dirname(os.path.abspath(self.path))
        os.makedirs(folder, exist_ok=True)
        blob = {"version": CACHE_VERSION, "entries": self.entries}
        # atomic replace, so a crashed process never truncates the cache
        fd, tmp = tempfile.mkstemp(dir=folder, suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(blob, f, indent=1, sort_keys=True)
            os.replace(tmp, self.path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise

    def get(self, spec: KernelSpec) -> Optional[CoarseningConfig]:
        e = self.entries.get(spec.key)
        if e is None:
            self._c_misses.inc()
            return None
        self._c_hits.inc()
        return CoarseningConfig.parse(e["cfg"])

    def put(self, spec: KernelSpec, cfg: CoarseningConfig, *,
            modeled_s: float, measured_s: Optional[float] = None,
            source: str = "model", persist: bool = True) -> None:
        self.entries[spec.key] = {
            "cfg": cfg.label,
            "modeled_s": modeled_s,
            "measured_s": measured_s,
            "source": source,
        }
        if persist:
            try:
                self.save()
            except OSError as e:
                # an unwritable cache must not break the dispatch: keep the
                # winner in memory and warn once per cache
                if not self._warned_unwritable:
                    self._warned_unwritable = True
                    print(f"repro_torch.tune: cannot persist tuning cache "
                          f"to {self.path}: {e} (continuing in memory)")

    def __len__(self) -> int:
        return len(self.entries)


_DEFAULT: dict[str, TuningCache] = {}


def default_cache() -> TuningCache:
    """The process-wide cache of the current path, re-resolved per call so
    that repointing ``REPRO_TORCH_TUNE_CACHE`` takes effect."""
    path = default_cache_path()
    cache = _DEFAULT.get(path)
    if cache is None:
        cache = _DEFAULT[path] = TuningCache(path)
    return cache
