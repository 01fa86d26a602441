"""Durable checkpoints of host arrays: one ``.npy`` a leaf and a JSON
manifest, written atomically and verified by crc32 on load.

- **atomic**: a checkpoint is written into ``<dir>/tmp.<step>`` and
  published by one rename to ``step_<step>``, so a crash in the middle of
  a write never corrupts the latest checkpoint;
- **integrity**: the manifest records each leaf's crc32, checked on load;
- **async**: ``CheckpointManager(async_save=True)`` snapshots the tree to
  host memory, then writes it from a daemon thread while the caller goes
  on.

The port's copy of ``repro.ckpt.store`` (numpy and host threads): the
streaming replay runner's template-free :func:`load_checkpoint_raw`, and
the trainer's :func:`load_checkpoint` into a template's structure and
devices.  Trees are those of ``repro_torch.tree``: dicts, lists, tuples
and dataclasses, keys joined by ``/``.  Leaves are stored whole: a DTensor
leaf (the sharded layout) is gathered on every rank and written by the
mesh's first rank only (``CheckpointManager(mesh=)``), and a template's
DTensor leaf is restored into each rank's shard of its placements; so a
checkpoint written over a mesh restores on one device, and the other way
round.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import zlib
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.sharding.rules import all_reduce_mesh, distribute, mesh_of
from repro_torch.tree import tree_items, tree_map, tree_map_with_path


def _host(leaf) -> np.ndarray:
    """A host copy of a leaf, never a view of memory the caller may
    update in place; a DTensor gathered whole (a collective: every rank of
    its mesh calls it)."""
    if isinstance(leaf, torch.Tensor):
        if mesh_of(leaf) is not None:
            leaf = leaf.full_tensor()
        return np.array(leaf.detach().cpu())
    return np.array(leaf)


def save_checkpoint(ckpt_dir: str, step: int, tree: Any, *,
                    extra: Optional[dict] = None, keep: int = 3) -> str:
    """Write ``tree`` to ``<ckpt_dir>/step_<step>/`` atomically, keeping
    the ``keep`` newest steps; returns the checkpoint's path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = os.path.join(ckpt_dir, f"tmp.{step}")
    final = os.path.join(ckpt_dir, f"step_{step}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    manifest = {"step": step, "leaves": [], "extra": extra or {}}
    for i, (key, leaf) in enumerate(tree_items(tree)):
        arr = _host(leaf)
        fname = f"leaf_{i:05d}.npy"
        np.save(os.path.join(tmp, fname), arr)
        manifest["leaves"].append({
            "key": key, "file": fname, "shape": list(arr.shape),
            "dtype": str(arr.dtype), "crc32": zlib.crc32(arr.tobytes())})
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    _gc(ckpt_dir, keep)
    return final


def _gc(ckpt_dir: str, keep: int) -> None:
    """Remove all but the ``keep`` newest steps (none when ``keep <= 0``)."""
    steps = sorted((int(d.split("_")[1]), d) for d in os.listdir(ckpt_dir)
                   if d.startswith("step_"))
    for _, d in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)


def latest_step(ckpt_dir: str) -> Optional[int]:
    """The newest published step under ``ckpt_dir``, or ``None``."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
             if d.startswith("step_")]
    return max(steps) if steps else None


def load_checkpoint_raw(ckpt_dir: str, *, step: Optional[int] = None,
                        verify: bool = True) -> tuple:
    """``(leaves, step, extra)`` of a checkpoint (the newest by default):
    ``leaves`` maps each flattened key to its host array.  A leaf whose
    crc32 disagrees with the manifest raises ``IOError``."""
    step = step if step is not None else latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    path = os.path.join(ckpt_dir, f"step_{step}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    leaves = {}
    for rec in manifest["leaves"]:
        arr = np.load(os.path.join(path, rec["file"]))
        if verify and zlib.crc32(arr.tobytes()) != rec["crc32"]:
            raise IOError(f"crc mismatch for leaf {rec['key']!r} in {path}")
        leaves[rec["key"]] = arr
    return leaves, manifest["step"], manifest.get("extra", {})


def load_checkpoint(ckpt_dir: str, template: Any, *,
                    step: Optional[int] = None, verify: bool = True):
    """Restore into ``template``'s structure: ``(tree, step, extra)``.

    Each leaf is looked up by its key, checked against the manifest's crc32
    and the template leaf's shape, and placed on the template leaf's device
    (a tensor leaf) or returned as a host array."""
    step = step if step is not None else latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    path = os.path.join(ckpt_dir, f"step_{step}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    by_key = {rec["key"]: rec for rec in manifest["leaves"]}

    def restore(key, tmpl):
        rec = by_key.get(key)
        if rec is None:
            raise KeyError(f"checkpoint missing leaf {key!r}")
        arr = np.load(os.path.join(path, rec["file"]))
        if verify and zlib.crc32(arr.tobytes()) != rec["crc32"]:
            raise IOError(f"crc mismatch for leaf {key!r} in {path}")
        if tuple(arr.shape) != tuple(np.shape(tmpl)):
            raise ValueError(
                f"checkpoint leaf {key!r} has shape {arr.shape}, template "
                f"expects {tuple(np.shape(tmpl))}: wrong model/config for "
                "this checkpoint directory?")
        if isinstance(tmpl, torch.Tensor):
            full = torch.from_numpy(arr).to(tmpl.device)
            mesh = mesh_of(tmpl)
            return full if mesh is None else distribute(full, mesh,
                                                        tmpl.placements)
        return arr

    tree = tree_map_with_path(restore, template)
    return tree, manifest["step"], manifest.get("extra", {})


class CheckpointManager:
    """keep-last-k manager with optional async writes.  Over a ``mesh``
    (a directory every rank reads) each rank gathers the tree, the mesh's
    first rank writes it, and :meth:`wait` holds every rank until the
    write is published."""

    def __init__(self, ckpt_dir: str, *, keep: int = 3,
                 async_save: bool = False, mesh=None):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self.async_save = async_save
        self.mesh = mesh
        self._writes = mesh is None or not any(mesh.get_coordinate())
        self._thread: Optional[threading.Thread] = None
        self.last_saved: Optional[int] = None

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self.mesh is not None:       # a barrier over the mesh
            all_reduce_mesh(torch.zeros(1), self.mesh)

    def save(self, step: int, tree: Any, *, extra: Optional[dict] = None):
        host_tree = tree_map(_host, tree)          # snapshot
        self.wait()
        self.last_saved = step
        if not self._writes:            # another rank of the mesh writes
            return
        if self.async_save:
            self._thread = threading.Thread(
                target=save_checkpoint, args=(self.ckpt_dir, step, host_tree),
                kwargs={"extra": extra, "keep": self.keep}, daemon=True)
            self._thread.start()
        else:
            save_checkpoint(self.ckpt_dir, step, host_tree, extra=extra,
                            keep=self.keep)

    def restore(self, template: Any, *, step: Optional[int] = None):
        return load_checkpoint(self.ckpt_dir, template, step=step)
