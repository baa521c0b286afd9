"""Atomic, async checkpointing of tensor trees (port of the reference's
checkpoint/checkpointer.py, one device: no sharded restore).

Layout: <dir>/step_<n>/   arr_<i>.npy (one a leaf) + manifest.json, the
reference's own.  Leaves are numbered in `jax.tree.flatten`'s order
(`models/params.tree_flatten`: dict keys sorted, tuples in order), and a
dtype numpy cannot store (bf16, fp8) is written as its raw unsigned view
with the true dtype in the manifest, so each package restores the other's
checkpoints bit for bit.  A commit is atomic: the step is written to
step_<n>.tmp and renamed, so an interrupted save never leaves a partial
step_<n>.  `save_async` copies the device tensors to host before its thread
starts, and the thread only writes files: the train loop runs the next
step over the disk write.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.models.params import tree_flatten, tree_unflatten

# dtype names of the manifest (the reference's `str(np.dtype)`) <-> torch
_DTYPES = {"float64": torch.float64, "float32": torch.float32,
           "float16": torch.float16, "bfloat16": torch.bfloat16,
           "int64": torch.int64, "int32": torch.int32, "int16": torch.int16,
           "int8": torch.int8, "uint8": torch.uint8, "bool": torch.bool,
           "float8_e4m3fn": torch.float8_e4m3fn,
           "float8_e5m2": torch.float8_e5m2}
_NAMES = {v: k for k, v in _DTYPES.items()}
# stored as the raw unsigned view of their width (numpy has no such dtype)
_RAW = {"bfloat16": (torch.int16, np.uint16),
        "float8_e4m3fn": (torch.int8, np.uint8),
        "float8_e5m2": (torch.int8, np.uint8)}
_RAW_NP = {2: np.uint16, 1: np.uint8}


def _to_host(x) -> tuple:
    """A leaf -> (numpy array as saved, manifest dtype name)."""
    if isinstance(x, torch.Tensor):
        t = x.detach().to("cpu", copy=True)    # a snapshot, even on the CPU
        name = _NAMES.get(t.dtype)
        if name is None:
            raise TypeError(f"Checkpointer: cannot store a {t.dtype} leaf")
        if name in _RAW:
            view, npv = _RAW[name]
            return t.contiguous().view(view).numpy().view(npv), name
        return t.numpy(), name
    arr = np.asarray(x)
    name = str(arr.dtype)
    if name not in _DTYPES or name in _RAW:
        # an ml_dtypes array (the reference's bf16 leaves): its raw view
        return arr.view(_RAW_NP[arr.dtype.itemsize]), name
    return arr, name


def _from_saved(arr: np.ndarray, name: str) -> torch.Tensor:
    if name in _RAW:
        view, npv = _RAW[name]
        raw = torch.from_numpy(np.asarray(arr.view(npv), order="C").view(
            np.int16 if npv == np.uint16 else np.int8))
        return raw.view(_DTYPES[name])
    return torch.from_numpy(np.asarray(arr, order="C")).to(_DTYPES[name])


class Checkpointer:
    def __init__(self, directory: str, *, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        os.makedirs(directory, exist_ok=True)

    # -- save ---------------------------------------------------------------
    def _write(self, host, treedef_repr: str, step: int,
               meta: Optional[dict]):
        final = os.path.join(self.directory, f"step_{step:08d}")
        if os.path.exists(final):      # this step is already committed
            return
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        manifest = {"step": step, "n_leaves": len(host),
                    "treedef": treedef_repr, "time": time.time(),
                    "meta": meta or {},
                    "dtypes": [name for _, name in host],
                    "shapes": [list(a.shape) for a, _ in host]}
        for i, (arr, _) in enumerate(host):
            np.save(os.path.join(tmp, f"arr_{i}.npy"), arr)
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        os.replace(tmp, final)                       # atomic commit
        self._gc()

    def save(self, state: Any, step: int, *, meta: Optional[dict] = None,
             block: bool = True):
        self.wait()
        leaves, treedef = tree_flatten(state)
        host = [_to_host(x) for x in leaves]         # device -> host copy
        if block:
            self._write(host, str(treedef), step, meta)
        else:
            self._thread = threading.Thread(
                target=self._write, args=(host, str(treedef), step, meta),
                daemon=True)
            self._thread.start()

    def save_async(self, state: Any, step: int, *,
                   meta: Optional[dict] = None):
        self.save(state, step, meta=meta, block=False)

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self):
        steps = sorted(self.all_steps())
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"),
                          ignore_errors=True)

    # -- restore ------------------------------------------------------------
    def all_steps(self):
        out = []
        for d in os.listdir(self.directory):
            if d.startswith("step_") and not d.endswith(".tmp"):
                out.append(int(d.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, state_like: Any, *, step: Optional[int] = None,
                device=None) -> Any:
        """state_like: a tree of the target structure whose leaves carry
        shape, dtype and device (tensors; "meta" tensors allocate nothing).
        Each leaf is restored at its like's dtype on its like's device, or
        on `device` when given (which a "meta" like needs).  Raises on a
        leaf count or shape that does not match."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        path = os.path.join(self.directory, f"step_{step:08d}")
        manifest = self.manifest(step)
        leaves, treedef = tree_flatten(state_like)
        if manifest["n_leaves"] != len(leaves):
            raise ValueError(f"{path}: {manifest['n_leaves']} leaves, the "
                             f"target tree has {len(leaves)}")
        out = []
        for i, like in enumerate(leaves):
            t = _from_saved(np.load(os.path.join(path, f"arr_{i}.npy")),
                            manifest["dtypes"][i])
            if tuple(t.shape) != tuple(like.shape):
                raise ValueError(f"{path}: leaf {i} has shape "
                                 f"{tuple(t.shape)}, the target "
                                 f"{tuple(like.shape)}")
            dev = device if device is not None else like.device
            out.append(t.to(device=dev, dtype=like.dtype))
        return tree_unflatten(treedef, out)

    def manifest(self, step: Optional[int] = None) -> dict:
        step = step if step is not None else self.latest_step()
        path = os.path.join(self.directory, f"step_{step:08d}",
                            "manifest.json")
        with open(path) as f:
            return json.load(f)
