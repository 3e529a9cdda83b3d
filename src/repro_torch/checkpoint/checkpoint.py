"""npz checkpoints in the reference's format (the port of
``repro.checkpoint.checkpoint``), so that either package reads what the
other wrote.

A nested tree of dicts and lists maps onto flat npz keys joined by '/'
('/' is legal in npz names). The metadata (training step, ``extra``,
per-key sharding specs and dtypes) is stored as JSON bytes inside the
npz under a reserved key, with a human-readable ``.meta.json`` sidecar
beside it. bfloat16 leaves are stored as their uint16 bits and named in
``dtypes``. Tensors are written from CPU copies; ``restore`` puts every
array onto the ``device`` it is given (the reference's ``shardings``
have no counterpart on one card).

Crash safety: writes go to a temp file in the target directory, are
fsynced, then atomically renamed over the destination (with a
best-effort directory fsync), so a kill at ANY point leaves either the
old complete checkpoint or the new complete one — never a torn file
under the real name — and a failed write cleans its temp file up.
``restore`` converts a torn/truncated file (e.g. a checkpoint copied
off a machine that died mid-write, before the rename) into a
``ValueError`` naming the path instead of a raw zip traceback.
"""
from __future__ import annotations

import json
import os
import tempfile
import zipfile
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device


def _flatten(tree, prefix="") -> Dict[str, Any]:
    flat = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            flat.update(_flatten(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)) and not hasattr(tree, "shape"):
        for i, v in enumerate(tree):
            flat.update(_flatten(v, f"{prefix}{i}/"))
    elif tree is None:
        pass
    else:
        flat[prefix[:-1]] = tree
    return flat


def _to_tensor(arr: np.ndarray, device) -> torch.Tensor:
    """An npz array as a tensor on ``device``. Unsigned words wider than a
    byte (the reference's uint32 RNG keys) become int64, value for value:
    torch has no arithmetic on them."""
    if arr.dtype.kind == "u" and arr.dtype.itemsize > 1:
        arr = arr.astype(np.int64)
    return torch.from_numpy(np.array(arr)).to(device)


def unflatten_like(template, flat: Dict[str, Any], prefix: str = "",
                   device="cuda"):
    """Exact inverse of ``_flatten`` given a structural template.

    ``template`` is any tree of the same STRUCTURE as what was saved
    (dicts / lists / tuples / NamedTuples / None / tensor-likes); leaf
    values are looked up in ``flat`` by the keys ``_flatten`` would have
    produced and returned as tensors on ``device``. Missing keys fail
    loudly.
    """
    if isinstance(template, dict):
        return {k: unflatten_like(v, flat, f"{prefix}{k}/", device)
                for k, v in template.items()}
    if isinstance(template, (list, tuple)) and not hasattr(template,
                                                           "shape"):
        vals = [unflatten_like(v, flat, f"{prefix}{i}/", device)
                for i, v in enumerate(template)]
        if isinstance(template, tuple):
            # NamedTuples rebuild through their constructor
            return (type(template)(*vals) if hasattr(template, "_fields")
                    else tuple(vals))
        return vals
    if template is None:
        return None
    key = prefix[:-1]
    if key not in flat:
        raise KeyError(f"checkpoint is missing {key!r}; have "
                       f"{sorted(flat)[:8]}...")
    v = flat[key]
    dev = resolve_device(device)
    return v.to(dev) if torch.is_tensor(v) else _to_tensor(np.asarray(v), dev)


_META_KEY = "__meta__"


def _host_array(v) -> Tuple[np.ndarray, bool]:
    """``(numpy array, is_bfloat16)`` of one leaf, bfloat16 as its uint16
    bits."""
    if torch.is_tensor(v):
        t = v.detach().resolve_conj().resolve_neg().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), True
        return t.numpy(), False
    arr = np.asarray(v)
    if arr.dtype.name == "bfloat16":    # ml_dtypes' bfloat16
        return arr.view(np.uint16), True
    return arr, False


def save(path: str, params: Dict[str, Any], *, step: int = 0,
         extra: Optional[Dict[str, Any]] = None,
         specs: Optional[Dict[str, str]] = None) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    flat = _flatten(params)
    if _META_KEY in flat:
        raise ValueError(f"param key {_META_KEY!r} is reserved")
    arrays = {}
    meta = {"step": step, "extra": extra or {}, "specs": specs or {},
            "dtypes": {}}
    for k, v in flat.items():
        arr, bf16 = _host_array(v)
        if bf16:
            meta["dtypes"][k] = "bfloat16"
        arrays[k] = arr
    # meta rides INSIDE the npz so the single atomic rename keeps arrays
    # and metadata consistent even on a kill mid-save; the json sidecar
    # is a best-effort human-readable copy
    meta_blob = json.dumps(meta).encode()
    arrays[_META_KEY] = np.frombuffer(meta_blob, dtype=np.uint8)
    d = os.path.dirname(os.path.abspath(path))
    _atomic_write(path, d, ".npz",
                  lambda f: np.savez(f, **arrays))
    _atomic_write(path + ".meta.json", d, ".json",
                  lambda f: f.write(json.dumps(meta).encode()))


def _atomic_write(path: str, d: str, suffix: str, write) -> None:
    """tmp-in-same-dir -> write -> flush+fsync -> rename; the temp file
    is unlinked if anything before the rename fails, and the directory
    entry is fsynced after it (best effort — not all filesystems allow
    directory fds) so the rename itself survives a power cut."""
    tmp = None
    try:
        with tempfile.NamedTemporaryFile(dir=d, suffix=suffix,
                                         delete=False) as f:
            tmp = f.name
            write(f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        tmp = None
    finally:
        if tmp is not None and os.path.exists(tmp):
            os.unlink(tmp)
    try:
        dfd = os.open(d, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(dfd)
    except OSError:
        pass
    finally:
        os.close(dfd)


def restore(path: str, device="cuda"
            ) -> Tuple[Dict[str, torch.Tensor], Dict[str, Any]]:
    """``(flat dict of tensors on device, metadata)`` of a checkpoint
    written by either package."""
    dev = resolve_device(device)
    try:
        with np.load(path) as z:
            arrays = {k: z[k] for k in z.files}
    except FileNotFoundError:
        raise
    except (zipfile.BadZipFile, EOFError, OSError, ValueError,
            KeyError) as e:
        # a truncated/torn npz (copy of a mid-write temp file, partial
        # download, disk-full tail) fails as a corrupt zip member —
        # name the file instead of leaking the zip internals
        raise ValueError(
            f"{path} is torn or not a checkpoint (atomic saves never "
            f"leave one under the real name — was this a partial "
            f"copy?): {e}") from e
    meta = {"step": 0, "extra": {}, "specs": {}, "dtypes": {}}
    if _META_KEY in arrays:  # authoritative (atomic with the arrays)
        meta = json.loads(arrays.pop(_META_KEY).tobytes().decode())
    elif os.path.exists(path + ".meta.json"):  # pre-embed checkpoints
        with open(path + ".meta.json") as f:
            meta = json.load(f)
    out = {}
    for k, arr in arrays.items():
        if meta["dtypes"].get(k) == "bfloat16":
            out[k] = torch.from_numpy(np.array(arr.view(np.int16))).view(
                torch.bfloat16).to(dev)
        else:
            out[k] = _to_tensor(arr, dev)
    return out, meta
