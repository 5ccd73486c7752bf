"""Checkpointing: per-host shard files, atomic commit, async save, restore.

Counterpart of ``repro.ckpt.checkpoint`` with the same layout on disk, so
either package restores what the other saved:

    <dir>/step_000000120/
        meta.json            # step, leaf paths with shapes and dtypes
        shard_00000.npz      # this host's leaves, keyed by keystr path
        COMMIT               # written last: a directory without it is torn

Leaves are keyed as ``jax.tree_util.keystr`` names them
(``.params['embed']``, ``.opt.count``; see ``repro_torch.tree``). numpy
has no bfloat16, so a bf16 leaf is written as the reference writes it, as
2-byte void (``V2``) items with ``"bfloat16"`` in ``meta.json``, and read
back through an int16 view. Data goes into a ``.tmp`` directory that is
renamed into place, and the newest ``keep`` committed steps are kept.
``save_async`` copies the state to host memory before it returns and
writes it in a background thread.

A state of DTensors (a sharded train state) is saved as whole leaves in
the same layout: every rank gathers each leaf (``full_tensor``), rank 0
writes, and the others wait for the commit at the next ``wait``.
``restore(..., shardings=)`` places each leaf on the given mesh and
placements, so the mesh that restores may differ from the one that saved.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from ..device import DeviceLike, resolve_device
from ..parallel.sharding import full, place, place_as
from ..tree import flatten_with_path, leaves, unflatten_like

BF16 = "bfloat16"


def _host_copy(leaf) -> np.ndarray:
    """A host copy of a leaf that later updates of the leaf cannot touch:
    ``.cpu()`` copies a device tensor but returns a CPU tensor itself."""
    t = torch.as_tensor(leaf).detach()
    t = t.clone() if t.device.type == "cpu" else t.cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.dtype("V2"))
    return t.numpy()


def _from_host(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    if dtype_name == BF16:
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _snapshot(tree, keep: bool = True) -> Dict[str, np.ndarray]:
    """Host copies of the whole leaves; every rank gathers a DTensor leaf,
    only a rank that ``keep``s copies it."""
    out = {}
    for path, leaf in flatten_with_path(tree):
        whole = full(leaf)
        if keep:
            out[path] = _host_copy(whole)
    return out


def _sharded(tree) -> bool:
    return any(isinstance(leaf, DTensor) for leaf in leaves(tree))


class CheckpointManager:
    def __init__(self, directory, keep: int = 3, host_id: int = 0):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.host_id = host_id
        self._thread: Optional[threading.Thread] = None
        self._last_error: Optional[BaseException] = None
        self._commit_barrier = False  # a sharded save the other ranks wait for

    # ------------------------------------------------------------------
    def step_dir(self, step: int) -> Path:
        return self.dir / f"step_{step:09d}"

    def _committed(self):
        return sorted(int(p.name.split("_")[1]) for p in self.dir.glob("step_*")
                      if (p / "COMMIT").exists())

    def latest_step(self) -> Optional[int]:
        steps = self._committed()
        return steps[-1] if steps else None

    # ------------------------------------------------------------------
    def save(self, step: int, tree: Any) -> Path:
        """Synchronous atomic save."""
        self._save(step, tree, background=False)
        self.wait()
        return self.step_dir(step)

    def save_async(self, step: int, tree: Any) -> None:
        """Snapshot to host memory now, write in the background. Joins any
        previous save first."""
        self._save(step, tree, background=True)

    def _save(self, step: int, tree: Any, background: bool) -> None:
        """A sharded state is gathered by every rank and written by rank 0."""
        self.wait()
        self._commit_barrier = _sharded(tree)
        writer = not self._commit_barrier or dist.get_rank() == 0
        arrays = _snapshot(tree, keep=writer)
        if not writer:
            return

        def worker():
            try:
                self._write(step, arrays)
            except BaseException as e:  # noqa: BLE001 - raised again by wait()
                self._last_error = e

        if not background:
            worker()
            return
        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._commit_barrier:
            self._commit_barrier = False
            dist.barrier()
        if self._last_error is not None:
            err, self._last_error = self._last_error, None
            raise err

    # ------------------------------------------------------------------
    def _write(self, step: int, arrays: Dict[str, np.ndarray]) -> Path:
        final = self.step_dir(step)
        tmp = final.with_suffix(".tmp")
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        np.savez(tmp / f"shard_{self.host_id:05d}.npz", **arrays)
        meta = {
            "step": step,
            "paths": {k: {"shape": list(v.shape),
                          "dtype": BF16 if v.dtype == np.dtype("V2") else str(v.dtype)}
                      for k, v in arrays.items()},
            "time": time.time(),
        }
        with open(tmp / "meta.json", "w") as f:
            json.dump(meta, f)
            f.flush()
            os.fsync(f.fileno())
        if final.exists():
            shutil.rmtree(final)
        os.rename(tmp, final)
        (final / "COMMIT").touch()
        self._retain()
        return final

    def _retain(self) -> None:
        for s in self._committed()[: -self.keep] if self.keep else []:
            shutil.rmtree(self.step_dir(s), ignore_errors=True)

    # ------------------------------------------------------------------
    def restore(self, like: Any, step: Optional[int] = None,
                device: Optional[DeviceLike] = None, shardings: Any = None) -> Any:
        """The checkpoint at ``step`` (default: the latest committed) in the
        structure of ``like``, each leaf cast to the dtype of its ``like``
        leaf and placed on ``device`` (default: that leaf's device). With
        ``shardings`` (a tree of ``Sharding``), each leaf becomes a DTensor
        on its mesh and placements (elastic: any mesh); a DTensor ``like``
        leaf with no sharding given keeps its own layout."""
        device = None if device is None else resolve_device(device)
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint in {self.dir}")
        d = self.step_dir(step)
        dtypes = {k: v["dtype"] for k, v in json.loads((d / "meta.json").read_text())
                  ["paths"].items()}
        data: Dict[str, np.ndarray] = {}
        for shard_file in sorted(d.glob("shard_*.npz")):
            with np.load(shard_file) as z:
                for k in z.files:
                    data[k] = z[k]
        flat = flatten_with_path(like)
        missing = [p for p, _ in flat if p not in data]
        if missing:
            raise KeyError(f"checkpoint {d} missing leaves: {missing[:5]}...")
        shs = leaves(shardings) if shardings is not None else [None] * len(flat)
        out = []
        for (path, ref), sh in zip(flat, shs, strict=True):
            t = _from_host(data[path], dtypes[path])
            if sh is not None:
                out.append(place(t.to(device=sh.mesh.device_type, dtype=ref.dtype), sh))
            elif isinstance(ref, DTensor):
                out.append(place_as(t.to(device=ref.device, dtype=ref.dtype), ref))
            else:
                ref = torch.as_tensor(ref)
                out.append(t.to(device=ref.device if device is None else device, dtype=ref.dtype))
        return unflatten_like(like, out)
