"""Durable checkpoints of host arrays: one ``.npy`` a leaf and a JSON
manifest, written atomically and verified by crc32 on load.

- **atomic**: a checkpoint is written into ``<dir>/tmp.<step>`` and
  published by one rename to ``step_<step>``, so a crash in the middle of
  a write never corrupts the latest checkpoint;
- **integrity**: the manifest records each leaf's crc32, checked on load.

The port's copy of what the streaming replay runner uses of
``repro.ckpt.store`` (numpy only): :func:`save_checkpoint`,
:func:`load_checkpoint_raw`, :func:`latest_step`.  The template-based
restore and the manager serve training, which the port does not carry
yet (ROADMAP Queue 1 item 10).
"""

from __future__ import annotations

import json
import os
import shutil
import zlib
from typing import Any, Optional

import numpy as np


def _flatten(tree: Any, prefix: str = "") -> list:
    """``[(key, leaf)]`` of a tree of dicts, lists and tuples, dict keys in
    sorted order and joined by ``/``."""
    if isinstance(tree, dict):
        items = sorted(tree.items())
    elif isinstance(tree, (list, tuple)):
        items = list(enumerate(tree))
    else:
        return [(prefix, tree)]
    out = []
    for k, v in items:
        out += _flatten(v, f"{prefix}/{k}" if prefix else str(k))
    return out


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
    for i, (key, leaf) in enumerate(_flatten(tree)):
        arr = np.asarray(leaf)
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
