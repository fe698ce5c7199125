"""Checkpointing with step management and async writes, in the JAX
package's on-disk format.

A copy of ``repro/checkpoint/checkpointer.py``.  Layout:
``<dir>/step_<n>/state.npz`` (leaves keyed by their ``keystr`` tree path)
plus ``meta.json`` (step, time, host, and a map of each key's dtype and
shape) and a ``COMMITTED`` marker.  bfloat16 leaves are stored as their raw
bytes (npz cannot hold bf16) and named "bfloat16" in the dtype map, through
``utils.BF16Array``, so no ``ml_dtypes`` is needed.  A checkpoint written by
either package restores in the other.

``save`` snapshots to host memory synchronously (so training can update
its tensors in place right away) and writes on a background thread; ``wait``
joins outstanding writes.  ``restore(template)`` rebuilds the tree from a
same-structure template, whose leaves need only shapes and dtypes (tensors
on the ``meta`` device will do), casting to the template's dtypes.
Retention keeps the newest ``keep`` steps.
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

from repro_torch.utils import (BF16Array, dtype_name, keystr, resolve_device, to_numpy,
                               to_tensor, tree_flatten_with_path, tree_unflatten)


def _flatten_with_keys(tree) -> dict[str, np.ndarray]:
    """keystr path -> an owning host copy of the leaf (a CPU tensor's numpy
    view would see later in-place updates)."""
    out = {}
    for path, leaf in tree_flatten_with_path(tree)[0]:
        arr = to_numpy(leaf)
        out[keystr(path)] = arr.copy() if isinstance(leaf, torch.Tensor) and not leaf.is_cuda \
            else arr
    return out


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3, host_id: int = 0) -> None:
        self.directory = directory
        self.keep = keep
        self.host_id = host_id
        os.makedirs(directory, exist_ok=True)
        self._threads: list[threading.Thread] = []

    # ------------------------------------------------------------------
    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:08d}")

    def steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.directory):
            if name.startswith("step_") and os.path.exists(
                    os.path.join(self.directory, name, "COMMITTED")):
                out.append(int(name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        s = self.steps()
        return s[-1] if s else None

    # ------------------------------------------------------------------
    def save(self, step: int, state: Any, blocking: bool = False) -> None:
        """Snapshot now, write in the background (async checkpointing)."""
        snap = _flatten_with_keys(state)

        def write():
            d = self._step_dir(step)
            tmp = d + ".tmp"
            if os.path.exists(tmp):
                shutil.rmtree(tmp)
            os.makedirs(tmp, exist_ok=True)
            # npz cannot hold bfloat16 directly -> store raw bytes + dtype map
            arrays, dtypes = {}, {}
            for k, v in snap.items():
                name = dtype_name(v)
                dtypes[k] = {"dtype": name, "shape": list(v.shape)}
                arrays[k] = np.asarray(v).view(np.uint8) if name == "bfloat16" else v
            np.savez(os.path.join(tmp, "state.npz"), **arrays)
            with open(os.path.join(tmp, "meta.json"), "w") as f:
                json.dump({"step": step, "time": time.time(),
                           "host": self.host_id, "dtypes": dtypes}, f)
            with open(os.path.join(tmp, "COMMITTED"), "w") as f:
                f.write("ok")
            if os.path.exists(d):
                shutil.rmtree(d)
            os.replace(tmp, d)
            self._gc()

        t = threading.Thread(target=write, daemon=True)
        t.start()
        self._threads.append(t)
        if blocking:
            t.join()

    def wait(self) -> None:
        for t in self._threads:
            t.join()
        self._threads.clear()

    def _gc(self) -> None:
        steps = self.steps()
        for s in steps[:-self.keep] if self.keep > 0 else []:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

    # ------------------------------------------------------------------
    def restore(self, template: Any, step: Optional[int] = None,
                device=None) -> tuple[Any, int]:
        """Returns (state, step).  ``template`` defines structure and dtypes;
        the leaves come back as tensors on ``device``.  By default each leaf
        follows its template tensor's device (a ``meta`` leaf describes only
        a shape and comes back in host memory), and a leaf the template
        gives no tensor for goes to the card (``resolve_device``), as the
        reference restores onto JAX's default device."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint in {self.directory}")
        d = self._step_dir(step)
        with open(os.path.join(d, "meta.json")) as f:
            meta = json.load(f)
        dtypes = meta["dtypes"]
        flat, treedef = tree_flatten_with_path(template)
        leaves = []
        with np.load(os.path.join(d, "state.npz")) as data:
            for path, leaf in flat:
                key = keystr(path)
                arr = data[key]
                info = dtypes[key]
                if info["dtype"] == "bfloat16":
                    arr = arr.view(np.uint16).reshape(info["shape"]).view(BF16Array)
                t = to_tensor(arr, _leaf_device(leaf) if device is None else device)
                want = leaf.dtype if isinstance(leaf, torch.Tensor) else t.dtype
                leaves.append(t.to(want))
        return tree_unflatten(treedef, leaves), step


def _leaf_device(leaf):
    if not isinstance(leaf, torch.Tensor):
        return resolve_device()
    return torch.device("cpu") if leaf.device.type == "meta" else leaf.device
