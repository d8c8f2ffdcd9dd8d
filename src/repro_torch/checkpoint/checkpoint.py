"""Sharded, atomic, async checkpointing with auto-resume (the port of
``repro/checkpoint/checkpoint.py``, with its on-disk layout).

Layout:  <dir>/step_<N:09d>/host_<i>.npz + manifest.json

* atomic: written through ``step_<N>.tmp-<i>/`` then renamed; the
  manifest is written last, so a partially written step directory is
  never restorable.
* async: ``save_async`` copies the state to host memory, then hands it to
  a writer thread; training continues at once (the in-place optimizer
  overwrites the tensors at the next step, so the copy is taken first).
* GC: the ``keep_n`` newest complete checkpoints are kept.
* restore picks the newest *complete* step (manifest present).

Leaves are keyed in the reference's spelling (``jax.tree_util.keystr``:
``['params']['blocks'][0]['mixer']['wq']``, dict keys sorted), so an f32
checkpoint reads across in both directions.  numpy has no bfloat16
without ``ml_dtypes``, so a bf16 leaf is stored as its ``uint16`` bits and
the manifest's ``dtypes`` names it: such a checkpoint does not read into
the reference.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, Optional, Tuple

import numpy as np
import torch


def _flat(tree, path: str = "") -> list:
    """``(key, tensor)`` pairs in ``jax.tree_util``'s order and spelling."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in _flat(tree[k], f"{path}[{k!r}]")]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree)
                for kv in _flat(v, f"{path}[{i}]")]
    return [(path, tree)]


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).removeprefix("torch.")


def _to_host(t: torch.Tensor) -> np.ndarray:
    """A host copy that later in-place writes to ``t`` do not reach."""
    t = t.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _from_host(a: np.ndarray, dtype_name: str) -> torch.Tensor:
    if dtype_name == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(a).view(np.int16)) \
            .view(torch.bfloat16)
    return torch.from_numpy(np.asarray(a))


class CheckpointManager:
    def __init__(self, directory: str, keep_n: int = 3, host_index: int = 0,
                 host_count: int = 1):
        self.dir = directory
        self.keep_n = keep_n
        self.host_index = host_index
        self.host_count = host_count
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:09d}")

    def save(self, state, step: int, block: bool = True):
        pairs = _flat(state)
        keys = [k for k, _ in pairs]
        dtypes = [_dtype_name(t) for _, t in pairs]
        host = [_to_host(t) for _, t in pairs]
        if block:
            self._write(keys, dtypes, host, step)
        else:
            self.wait()
            self._thread = threading.Thread(
                target=self._write_logged, args=(keys, dtypes, host, step),
                daemon=True)
            self._thread.start()

    def save_async(self, state, step: int):
        self.save(state, step, block=False)

    def wait(self):
        """Wait for the writer thread; re-raise what it raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _write_logged(self, *args):
        try:
            self._write(*args)
        except Exception as e:          # re-raised by wait()
            self._error = e

    def _write(self, keys, dtypes, leaves, step: int):
        sdir = self._step_dir(step)
        tmp = sdir + f".tmp-{self.host_index}"
        os.makedirs(tmp, exist_ok=True)
        path = os.path.join(tmp, f"host_{self.host_index}.npz")
        np.savez(path, **dict(zip(keys, leaves)))
        os.makedirs(sdir, exist_ok=True)
        os.replace(path, os.path.join(sdir, f"host_{self.host_index}.npz"))
        shutil.rmtree(tmp, ignore_errors=True)
        if self.host_index == 0:
            manifest = {"step": step, "host_count": self.host_count,
                        "time": time.time(), "keys": keys,
                        "dtypes": dtypes}
            mtmp = os.path.join(sdir, ".manifest.tmp")
            with open(mtmp, "w") as f:
                json.dump(manifest, f)
            os.replace(mtmp, os.path.join(sdir, "manifest.json"))
        self._gc()

    def complete_steps(self) -> list:
        steps = []
        if not os.path.isdir(self.dir):
            return steps
        for name in os.listdir(self.dir):
            if not name.startswith("step_") or ".tmp-" in name:
                continue
            if os.path.exists(os.path.join(self.dir, name, "manifest.json")):
                steps.append(int(name.split("_")[1]))
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.complete_steps()
        return steps[-1] if steps else None

    def restore(self, state_like, step: Optional[int] = None
                ) -> Tuple[Any, Optional[int]]:
        """Copy step ``step`` (the newest complete one by default) into
        the tensors of ``state_like``, in place, converting each leaf to
        its dtype.  Returns ``(state_like, step)``; ``(state_like, None)``
        when nothing is restorable."""
        if step is None:
            step = self.latest_step()
        if step is None:
            return state_like, None
        sdir = self._step_dir(step)
        with open(os.path.join(sdir, "manifest.json")) as f:
            manifest = json.load(f)
        # a checkpoint the reference wrote names no dtypes: numpy's own
        dtypes = dict(zip(manifest["keys"], manifest.get("dtypes", ())))
        with np.load(os.path.join(sdir, f"host_{self.host_index}.npz")) \
                as data, torch.no_grad():
            for k, leaf in _flat(state_like):
                arr = data[k]
                if tuple(arr.shape) != tuple(leaf.shape):
                    raise ValueError(f"{k}: checkpoint shape {arr.shape}, "
                                     f"state {tuple(leaf.shape)}")
                leaf.copy_(_from_host(arr, dtypes.get(k, "")))
        return state_like, step

    def _gc(self):
        for s in self.complete_steps()[:-self.keep_n]:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)
