"""Atomic checkpoints of a tree of tensors and arrays.

Counterpart of ``repro/checkpoint/checkpointer.py``, in the same on-disk
format, so that either package reads what the other wrote:

* ``directory/step_<N>/`` holds ``leaf_<i>.npy`` (the leaf's raw bytes
  as a flat uint8 array) and ``manifest.json`` (``step`` and, per leaf,
  its name, file, shape and numpy dtype name);
* a tree is a dict (keys in sorted order), list or tuple of leaves, and
  a leaf's name is its path as ``jax.tree_util.keystr`` writes it
  (``"['seg0_words']"`` for a key of a flat dict), numbered in that
  order;
* a step is written to ``step_<N>.tmp/``, its manifest fsynced, and the
  directory renamed, so a crash never leaves a partial ``step_<N>``;
  the newest ``keep`` steps are kept.

bfloat16 leaves are stored as their bytes under the dtype name
``bfloat16``; they are read back as uint16 bytes viewed as
``torch.bfloat16``, with no numpy extension type. Restored leaves are
tensors on the card unless ``device`` names another. Resharding on
restore is ROADMAP queue A item 13 and raises.
"""
from __future__ import annotations

import json
import os
import re
import shutil
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from repro_torch.device import resolve_device

__all__ = ["ShapeDtype", "save_checkpoint", "restore_checkpoint",
           "read_manifest", "latest_step", "available_steps"]

_STEP_RE = re.compile(r"^step_(\d+)$")
# numpy dtype name -> torch dtype (the unsigned types past uint8 only
# where this torch has them)
_TORCH = {name: getattr(torch, name) for name in (
    "bool", "uint8", "int8", "int16", "uint16", "int32", "uint32", "int64",
    "uint64", "float16", "bfloat16", "float32", "float64")
    if hasattr(torch, name)}
_NAME = {v: k for k, v in _TORCH.items()}


@dataclass(frozen=True)
class ShapeDtype:
    """A leaf of a ``like`` tree: its shape and dtype (a torch dtype or a
    numpy dtype name), the counterpart of ``jax.ShapeDtypeStruct``."""
    shape: tuple
    dtype: object


def _dtype_name(dtype) -> str:
    if isinstance(dtype, torch.dtype):
        return _NAME[dtype]
    return str(np.dtype(dtype)) if str(dtype) != "bfloat16" else "bfloat16"


def _flatten(tree, path: str = ""):
    """[(keystr path, leaf)] in the reference's order."""
    if isinstance(tree, dict):
        return [x for key in sorted(tree)
                for x in _flatten(tree[key], f"{path}[{key!r}]")]
    if isinstance(tree, (list, tuple)):
        return [x for i, sub in enumerate(tree)
                for x in _flatten(sub, f"{path}[{i}]")]
    return [(path, tree)]


def _unflatten(like, leaves):
    """``like``'s structure with its leaves taken in order from the
    iterator ``leaves``."""
    if isinstance(like, dict):
        return {key: _unflatten(like[key], leaves) for key in sorted(like)}
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(sub, leaves) for sub in like)
    return next(leaves)


def _to_numpy(x):
    """A leaf -> (numpy array of its bytes' dtype, dtype name)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        return x.numpy(), _NAME[x.dtype]
    arr = np.asarray(x)
    return arr, _dtype_name(arr.dtype)


def save_checkpoint(directory: str, step: int, tree, keep: int = 3) -> str:
    """Write ``tree`` at ``directory/step_<step>``; returns that path."""
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    manifest = {"step": step, "leaves": []}
    for i, (name, x) in enumerate(_flatten(tree)):
        arr, dtype = _to_numpy(x)
        shape = arr.shape      # before ascontiguousarray (0-d becomes 1-d)
        arr = np.ascontiguousarray(arr)
        fn = f"leaf_{i}.npy"
        np.save(os.path.join(tmp, fn), arr.reshape(-1).view(np.uint8))
        manifest["leaves"].append({"name": name, "file": fn,
                                   "shape": list(shape), "dtype": dtype})
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    _retain(directory, keep)
    return final


def _retain(directory: str, keep: int):
    for s in available_steps(directory)[:-keep]:
        shutil.rmtree(os.path.join(directory, f"step_{s}"),
                      ignore_errors=True)


def available_steps(directory: str) -> list:
    """Steps of the complete checkpoints (manifest present), ascending."""
    if not os.path.isdir(directory):
        return []
    out = []
    for d in os.listdir(directory):
        m = _STEP_RE.match(d)
        if m and os.path.exists(os.path.join(directory, d, "manifest.json")):
            out.append(int(m.group(1)))
    return sorted(out)


def latest_step(directory: str) -> Optional[int]:
    """The newest complete step, or None."""
    steps = available_steps(directory)
    return steps[-1] if steps else None


def read_manifest(directory: str, step: int) -> dict:
    """The step's manifest: leaf names, files, shapes and dtypes, enough
    to rebuild a ``like`` tree without knowing the saved structure."""
    with open(os.path.join(directory, f"step_{step}", "manifest.json")) as f:
        return json.load(f)


def _load_leaf(path: str, entry: dict, want: str) -> torch.Tensor:
    """A leaf's bytes -> CPU tensor of dtype ``want``. The cast runs in
    numpy (an unsigned integer read as the signed type of its width is a
    bit-view), so no unsigned torch type is needed; bfloat16 bytes are
    viewed as ``torch.bfloat16``."""
    raw = np.load(os.path.join(path, entry["file"])).reshape(-1)
    shape = tuple(entry["shape"])
    if "bfloat16" in (entry["dtype"], want):
        t = (torch.from_numpy(raw.view(np.int16).copy()).view(torch.bfloat16)
             if entry["dtype"] == "bfloat16"
             else torch.from_numpy(raw.view(np.dtype(entry["dtype"])).copy()))
        return t.reshape(shape).to(_TORCH[want])
    arr = raw.view(np.dtype(entry["dtype"])).reshape(shape)
    dt = np.dtype(want)
    if dt.kind in "iu" and arr.dtype.kind in "iu" and \
            dt.itemsize == arr.dtype.itemsize:
        arr = arr.view(dt)
    return torch.from_numpy(arr.astype(dt))


def restore_checkpoint(directory: str, step: int, like, shardings=None,
                       device=None):
    """Restore into the structure of ``like`` (a tree of tensors, arrays
    or ``ShapeDtype``s): each leaf is checked against its shape, cast to
    its dtype and placed on ``device`` (the card by default)."""
    if shardings is not None:
        raise NotImplementedError(
            "restoring onto a sharded layout is ROADMAP queue A item 13, "
            "not yet ported to repro_torch")
    dev = resolve_device(device)
    path = os.path.join(directory, f"step_{step}")
    by_name = {e["name"]: e for e in read_manifest(directory, step)["leaves"]}
    out = []
    for name, proto in _flatten(like):
        entry = by_name.get(name)
        if entry is None:
            raise KeyError(f"checkpoint at {path} missing leaf {name}")
        if tuple(entry["shape"]) != tuple(proto.shape):
            raise ValueError(f"{name}: checkpoint shape "
                             f"{tuple(entry['shape'])} != "
                             f"{tuple(proto.shape)}")
        out.append(_load_leaf(path, entry, _dtype_name(proto.dtype)).to(dev))
    return _unflatten(like, iter(out))
