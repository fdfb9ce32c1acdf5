"""Checkpointing: atomic, async, in the JAX package's on-disk layout (torch).

Counterpart of ``repro.training.checkpoint``.  One directory per step:

  <dir>/step_000123/
      arrays.npz        flat {path -> ndarray}, paths "params/blocks/attn/wq"
      index.json        step, and each array's shape and dtype
      COMMITTED         sentinel written LAST -> crash-safe atomicity

written under a temporary name and renamed into place.  The state is a
nested dict of tensors; its key paths and shapes are
those of the JAX state, so a checkpoint written by either package
restores in the other.  bfloat16 leaves are stored as their ``uint16``
bits with dtype "bfloat16" in the index, as the JAX package stores them
(no ``ml_dtypes`` is needed here).

``save`` copies every leaf to the host before it hands the write to a
thread: the trainer updates its tensors in place, and a leaf shared with
the file writer would let an async write record a later step's values.
``wait`` joins the writer; the most recent ``keep`` committed steps are
kept.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.utils.logging import get_logger

log = get_logger("checkpoint")


def _flatten(tree, prefix: str = "") -> Dict[str, Any]:
    """``{"a/b/c": leaf}`` over a nested dict (or list / tuple), JAX's key paths."""
    if isinstance(tree, dict):
        items = ((str(k), v) for k, v in tree.items())
    elif isinstance(tree, (list, tuple)):
        items = ((str(i), v) for i, v in enumerate(tree))
    else:
        return {prefix: tree}
    flat = {}
    for k, v in items:
        flat.update(_flatten(v, f"{prefix}/{k}" if prefix else k))
    return flat


def _unflatten_like(tree, flat: Dict[str, Any], prefix: str = ""):
    if isinstance(tree, dict):
        return {k: _unflatten_like(v, flat, f"{prefix}/{k}" if prefix else str(k))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_unflatten_like(v, flat, f"{prefix}/{i}" if prefix else str(i))
                          for i, v in enumerate(tree))
    return flat[prefix]


def _host_copy(t: torch.Tensor) -> np.ndarray:
    """A numpy copy of ``t`` that shares no memory with it; bfloat16 as uint16 bits."""
    t = t.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _dtype_name(t: torch.Tensor) -> str:
    return "bfloat16" if t.dtype == torch.bfloat16 else str(t.dtype).split(".")[-1]


class CheckpointManager:
    def __init__(self, directory: str | Path, keep: int = 3, async_write: bool = True):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.async_write = async_write
        self._thread: Optional[threading.Thread] = None

    # -- save ---------------------------------------------------------------
    def save(self, state, step: int):
        self.wait()
        flat = _flatten(state)
        host = {k: _host_copy(v) for k, v in flat.items()}
        index = {
            "step": int(step),
            "arrays": {
                k: {"shape": list(host[k].shape), "dtype": _dtype_name(v)}
                for k, v in flat.items()
            },
        }

        def write():
            final = self.dir / f"step_{step:08d}"
            tmp = self.dir / f".tmp_step_{step:08d}"
            if tmp.exists():
                shutil.rmtree(tmp)
            tmp.mkdir(parents=True)
            np.savez(tmp / "arrays.npz", **host)
            (tmp / "index.json").write_text(json.dumps(index, indent=2))
            (tmp / "COMMITTED").write_text("ok")
            if final.exists():
                shutil.rmtree(final)
            os.replace(tmp, final)
            log.info("checkpoint step %d written to %s", step, final)
            self._gc()

        if self.async_write:
            self._thread = threading.Thread(target=write, daemon=True)
            self._thread.start()
        else:
            write()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self):
        steps = self.all_steps()
        for s in steps[: -self.keep]:
            shutil.rmtree(self.dir / f"step_{s:08d}", ignore_errors=True)

    # -- restore ------------------------------------------------------------
    def all_steps(self):
        out = []
        for p in sorted(self.dir.glob("step_*")):
            if (p / "COMMITTED").exists():
                out.append(int(p.name.split("_")[1]))
        return out

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, state_like, step: Optional[int] = None):
        """Restore into the structure of ``state_like``: ``(state, step)``.

        Each leaf comes back as a tensor of the matching leaf's dtype, on its
        device; a shape that differs raises ``ValueError``, a missing key
        ``KeyError``.
        """
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no committed checkpoints in {self.dir}")
        d = self.dir / f"step_{step:08d}"
        index = json.loads((d / "index.json").read_text())
        flat_like = _flatten(state_like)
        out = {}
        with np.load(d / "arrays.npz") as arrays:
            missing = [k for k in flat_like if k not in arrays.files]
            if missing:
                raise KeyError(f"checkpoint missing keys: {missing[:5]}...")
            for key, ref in flat_like.items():
                arr = arrays[key]
                if tuple(arr.shape) != tuple(ref.shape):
                    raise ValueError(f"{key}: shape {arr.shape} != expected {tuple(ref.shape)}")
                if index["arrays"][key]["dtype"] == "bfloat16":
                    t = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)).view(
                        torch.bfloat16)
                else:
                    t = torch.from_numpy(np.array(arr, copy=True))
                out[key] = t.to(device=ref.device, dtype=ref.dtype)
        return _unflatten_like(state_like, out), step
