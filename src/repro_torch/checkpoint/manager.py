"""Atomic manifest-based checkpoints with async save, retention and
integrity hashes.  Mirrors `repro/checkpoint/manager.py`:
`save_checkpoint` (:60), `load_checkpoint` (:94) and `CheckpointManager`
(:120), with the same on-disk format:

  <dir>/step_<N>/manifest.json — leaf paths, shapes, dtypes, sha256, extra
  <dir>/step_<N>/arrays.npz    — every leaf, keyed by its path
  <dir>/step_<N>.tmp/          — staging, renamed atomically when complete
  <dir>/LATEST                 — the newest complete step

Leaves are host numpy arrays: floating tensors as float32, integer tensors
in their own type.  `load_checkpoint` fills a skeleton tree of tensors
and puts each leaf on its skeleton leaf's device and dtype.  The
reference's ``shardings`` (mesh restore) is not ported.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
import time
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.core.tree import map_tree

_SEP = "/"


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.update(_flatten(tree[k], f"{prefix}{k}{_SEP}"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}{_SEP}"))
    else:
        out[prefix[:-1]] = tree
    return out


def _unflatten_into(skeleton, flat, prefix=""):
    if isinstance(skeleton, dict):
        return {k: _unflatten_into(v, flat, f"{prefix}{k}{_SEP}")
                for k, v in skeleton.items()}
    if isinstance(skeleton, (list, tuple)):
        return type(skeleton)(_unflatten_into(v, flat, f"{prefix}{i}{_SEP}")
                              for i, v in enumerate(skeleton))
    return flat[prefix[:-1]]


def to_host(tree):
    """A host copy of a tree of tensors as numpy arrays (floating ->
    float32).  Always a copy, so later in-place updates of the tensors
    cannot reach a checkpoint being written."""
    def host(t):
        if isinstance(t, torch.Tensor):
            t = t.detach()
            if t.is_floating_point():
                t = t.to(torch.float32)
            return t.to("cpu", copy=True).numpy()
        return np.array(t, copy=True)
    return map_tree(host, tree)


def save_checkpoint(directory: str, step: int, tree: Any,
                    extra: Optional[dict] = None) -> str:
    """Atomic synchronous save of a tree of host arrays (or tensors);
    returns the final path."""
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    arrays = _flatten(to_host(tree))
    npz_path = os.path.join(tmp, "arrays.npz")
    np.savez(npz_path, **{k.replace(_SEP, "|"): v for k, v in arrays.items()})
    with open(npz_path, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()
    manifest = {
        "step": step,
        "time": time.time(),
        "sha256": digest,
        "leaves": {k: {"shape": list(v.shape), "dtype": str(v.dtype)}
                   for k, v in arrays.items()},
        "extra": extra or {},
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    with open(os.path.join(directory, "LATEST.tmp"), "w") as f:
        f.write(f"step_{step:08d}")
    os.replace(os.path.join(directory, "LATEST.tmp"),
               os.path.join(directory, "LATEST"))
    return final


def load_checkpoint(directory: str, skeleton: Any, step: Optional[int] = None,
                    verify: bool = True):
    """Restore into ``skeleton``'s structure -> (tree, manifest).  Each
    leaf lands on its skeleton leaf's device and dtype.  With ``verify``
    a sha256 mismatch of ``arrays.npz`` raises IOError."""
    if step is None:
        with open(os.path.join(directory, "LATEST")) as f:
            name = f.read().strip()
    else:
        name = f"step_{step:08d}"
    path = os.path.join(directory, name)
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    npz_path = os.path.join(path, "arrays.npz")
    if verify:
        with open(npz_path, "rb") as f:
            digest = hashlib.sha256(f.read()).hexdigest()
        if digest != manifest["sha256"]:
            raise IOError(f"checkpoint {path} integrity check failed")
    with np.load(npz_path) as data:
        flat = {k.replace("|", _SEP): data[k] for k in data.files}
    arrays = _unflatten_into(skeleton, flat)

    def place(a, like):
        t = torch.from_numpy(np.asarray(a))
        if isinstance(like, torch.Tensor):
            return t.to(device=like.device, dtype=like.dtype)
        return t
    return map_tree(place, arrays, skeleton), manifest


class CheckpointManager:
    """Async save + retention + auto-resume."""

    def __init__(self, directory: str, keep: int = 3,
                 save_interval_steps: int = 100):
        self.directory = directory
        self.keep = keep
        self.save_interval_steps = save_interval_steps
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        os.makedirs(directory, exist_ok=True)

    def should_save(self, step: int) -> bool:
        return step > 0 and step % self.save_interval_steps == 0

    def save(self, step: int, tree: Any, extra: Optional[dict] = None,
             blocking: bool = False) -> None:
        """Snapshot ``tree`` to host memory now, then write it on a
        background thread (or here, when ``blocking``)."""
        self.wait()
        host_tree = to_host(tree)

        def work():
            try:
                save_checkpoint(self.directory, step, host_tree, extra)
                self._gc()
            except BaseException as e:      # surfaced on the next wait()
                self._error = e

        if blocking:
            work()
            self.check()
        else:
            self._thread = threading.Thread(target=work, daemon=True)
            self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        self.check()

    def check(self) -> None:
        if self._error is not None:
            e, self._error = self._error, None
            raise e

    def latest_step(self) -> Optional[int]:
        latest = os.path.join(self.directory, "LATEST")
        if not os.path.exists(latest):
            return None
        with open(latest) as f:
            return int(f.read().strip().split("_")[1])

    def restore(self, skeleton: Any, step: Optional[int] = None):
        return load_checkpoint(self.directory, skeleton, step)

    def _gc(self) -> None:
        steps = sorted(
            int(d.split("_")[1]) for d in os.listdir(self.directory)
            if d.startswith("step_") and not d.endswith(".tmp"))
        for s in steps[:-self.keep] if self.keep > 0 else []:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"),
                          ignore_errors=True)
