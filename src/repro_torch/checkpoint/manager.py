"""Async, atomic checkpointing.

The JAX package's ``checkpoint/manager.py`` with PyTorch tensors, writing
the same layout: ``step_N/manifest.json`` and one ``.npy`` a leaf, so a
directory written by either package restores in the other.

  * **atomic** — arrays are written to ``step_N.tmp/`` and ``os.rename``d
    to ``step_N/`` only when complete; a crash mid-save never corrupts the
    latest checkpoint.
  * **async** — ``save()`` copies the tensors to host memory, then hands
    the file I/O to a background thread; training goes on at once.  An
    error in the writer is raised at the next ``wait()``.
  * **placement** — ``restore(..., device=)`` puts every leaf on
    ``device``; with ``mesh=`` and ``spec_tree=`` (the JAX package's
    ``shardings=``) each leaf the spec tree names is then placed onto the
    mesh as a DTensor, the elastic-restart path.  A DTensor leaf is saved
    whole (``full_tensor``).
  * **retention** — keeps the last ``keep`` checkpoints, deletes older.

bf16 has no numpy dtype.  A bf16 leaf is written as its 16-bit patterns
under the header ``'<V2'``, the bytes the JAX package writes for an
ml_dtypes bfloat16 array, and the manifest's ``dtypes`` entry names each
leaf's dtype (the JAX package's reader ignores the key).  Every 2-byte
void leaf (``|V2``) is read back as bf16 from those bits, with or without
the entry.
"""

from __future__ import annotations

import json
import os
import shutil
import threading

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from repro_torch.core.executor import resolve_device
from repro_torch.runtime.sharding import (distribute, is_placements,
                                           tree_sharding)

_BF16_DESCR = "<V2"


def _flatten(tree, prefix="", is_leaf=lambda t: False):
    out = {}
    if is_leaf(tree):
        out[prefix[:-1]] = tree
    elif isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/", is_leaf))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/", is_leaf))
    else:
        out[prefix[:-1]] = tree
    return out


def _unflatten(flat: dict):
    root: dict = {}
    for path, v in flat.items():
        parts = path.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return root


def _host(v) -> torch.Tensor | np.ndarray:
    """A snapshot of a leaf on the host: a copy, since training goes on
    updating its tensors in place."""
    if isinstance(v, DTensor):
        v = v.full_tensor()
    if isinstance(v, torch.Tensor):
        return v.detach().to("cpu", copy=True)
    return np.array(v)


def _save(path: str, v) -> str:
    """Write one leaf; returns its dtype's name."""
    if not isinstance(v, torch.Tensor):
        np.save(path, v)
        return str(v.dtype)
    if v.dtype == torch.bfloat16:
        bits = v.contiguous().view(torch.int16).numpy()
        with open(path, "wb") as f:
            np.lib.format.write_array_header_1_0(
                f, {"descr": _BF16_DESCR, "fortran_order": False,
                    "shape": tuple(v.shape)})
            f.write(bits.tobytes())
        return "bfloat16"
    np.save(path, v.numpy())
    return str(v.dtype).removeprefix("torch.")


def _load(path: str) -> torch.Tensor:
    arr = np.load(path)
    if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:  # bf16 bits
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: threading.Thread | None = None
        self._error: Exception | None = None

    # -- save ---------------------------------------------------------------

    def save(self, step: int, tree, *, blocking: bool = False):
        """Snapshot to host memory synchronously, write files
        asynchronously."""
        self.wait()  # one in-flight save at a time
        host = {k: _host(v) for k, v in _flatten(tree).items()}

        def write():
            try:
                tmp = os.path.join(self.dir, f"step_{step}.tmp")
                final = os.path.join(self.dir, f"step_{step}")
                os.makedirs(tmp, exist_ok=True)
                manifest, dtypes = {}, {}
                for k, v in host.items():
                    fname = k.replace("/", "__") + ".npy"
                    dtypes[k] = _save(os.path.join(tmp, fname), v)
                    manifest[k] = fname
                with open(os.path.join(tmp, "manifest.json"), "w") as f:
                    json.dump({"step": step, "arrays": manifest,
                               "dtypes": dtypes}, f)
                if os.path.exists(final):
                    shutil.rmtree(final)
                os.rename(tmp, final)  # atomic publish
                self._gc()
            except Exception as e:  # surfaced on next wait()
                self._error = e

        self._thread = threading.Thread(target=write, daemon=True)
        self._thread.start()
        if blocking:
            self.wait()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self):
        steps = sorted(self.all_steps())
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"),
                          ignore_errors=True)

    # -- restore ------------------------------------------------------------

    def all_steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp") and \
                    os.path.isdir(os.path.join(self.dir, name)):
                try:
                    out.append(int(name.split("_")[1]))
                except ValueError:
                    pass
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int | None = None, *, device=None, mesh=None,
                spec_tree=None, rules: dict | None = None):
        """Load a checkpoint (the latest if ``step`` is None) as a tree of
        tensors on ``device`` (None means the card).  With ``mesh`` and
        ``spec_tree``, each leaf whose path the spec tree names is placed
        onto the *current* mesh with the placements its logical axes take
        under ``rules`` (``runtime.sharding.tree_sharding``).  Returns
        ``(tree, step)``; lists come back as index-keyed dicts."""
        self.wait()
        dev = resolve_device(device)
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        d = os.path.join(self.dir, f"step_{step}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        flat = {k: _load(os.path.join(d, fname)).to(dev)
                for k, fname in manifest["arrays"].items()}
        if mesh is not None:
            placements = _flatten(tree_sharding(spec_tree, mesh, rules),
                                  is_leaf=is_placements)
            for k, pl in placements.items():
                if k in flat:
                    flat[k] = distribute(flat[k], mesh, pl)
        return _unflatten(flat), step
