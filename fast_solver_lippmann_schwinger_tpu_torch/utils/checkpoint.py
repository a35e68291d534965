"""Checkpoint / resume for expensive setup artifacts.

Counterpart of the JAX package's ``utils/checkpoint.py``.  The reference has
no checkpointing: every script rebuilds the kernel tables, annihilator
stencils and factorizations from scratch (SURVEY.md section 5).  The
expensive artifacts are exactly those: the spectral symbol (``GFFT``), the
host stencil fields (``As``/``AG``) and the slab factorizations in their
final pivot layout.  Each is one file ``<prefix>_<key>.pt`` in the cache
directory, keyed by the configuration hash of :func:`config_key`.

A file holds a tree of the port's frozen dataclasses, tuples, lists, numpy
arrays and tensors, written by ``torch.save`` and read back by
``torch.load(weights_only=True)``: no pickled code, only tensors and plain
values.  A dataclass is stored as its class path and its constructor fields;
fields that ``__post_init__`` rebuilds (``slab_ids``) and cached properties
are not stored.  Every tensor keeps its dtype (bf16 and int8 included) and is
written compact: a view into a larger storage is cloned first, so a file never
carries the rest of its base.  A file that cannot be read, was written in
another format, names a class this package does not have, or does not pass
the build function's check of its shapes and dtypes loads as ``None``: the
build function then recomputes and overwrites it, as the JAX package's ``load_arrays`` does.
"""

from __future__ import annotations

import dataclasses
import hashlib
import importlib
import json
import os
import pickle

import numpy as np
import torch

# written into every file and compared on load; bump it when the encoding
# changes, so an older file misses instead of decoding wrong
FORMAT = "fast_solver_lippmann_schwinger_tpu_torch.checkpoint/1"
# distinct from the JAX package's ``.npz``, so neither package reads the other's
SUFFIX = ".pt"
_PACKAGE = "fast_solver_lippmann_schwinger_tpu_torch"
# dataclass fields rebuilt by ``__post_init__`` from the stored ones
_REBUILT = frozenset({"slab_ids"})
# what ``torch.load`` raises on a truncated, foreign or non-weights file
_UNREADABLE = (OSError, EOFError, RuntimeError, ValueError, pickle.UnpicklingError)


class _Mismatch(Exception):
    """A stored tree that does not fit this package's classes."""


def config_key(**kwargs) -> str:
    """Stable short hash of a configuration dict."""
    blob = json.dumps(kwargs, sort_keys=True, default=str).encode()
    return hashlib.sha256(blob).hexdigest()[:16]


def digest(arr: np.ndarray) -> str:
    """sha256 of an array's bytes in C order (a key field for large inputs)."""
    return hashlib.sha256(np.ascontiguousarray(arr).tobytes()).hexdigest()


def path_for(cache_dir: str, prefix: str, /, **key_fields) -> str:
    """``<cache_dir>/<prefix>_<config_key(**key_fields)>.pt``."""
    return os.path.join(cache_dir, f"{prefix}_{config_key(**key_fields)}{SUFFIX}")


def _compact(t: torch.Tensor) -> torch.Tensor:
    """``t`` on the host with a storage of its own size (``torch.save`` writes
    a tensor's whole storage, so a view would carry its base along)."""
    t = t.detach().cpu()
    if t.storage_offset() or t.untyped_storage().nbytes() != t.numel() * t.element_size():
        t = t.clone(memory_format=torch.contiguous_format)
    return t


def _encode(obj):
    if isinstance(obj, torch.Tensor):
        return _compact(obj)
    if isinstance(obj, np.ndarray):
        return {"__ndarray__": torch.from_numpy(np.ascontiguousarray(obj))}
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        cls = type(obj)
        return {"__dataclass__": f"{cls.__module__}:{cls.__qualname__}",
                "fields": {f.name: _encode(getattr(obj, f.name))
                           for f in dataclasses.fields(obj)
                           if f.init and f.name not in _REBUILT}}
    if isinstance(obj, (tuple, list)):
        return type(obj)(_encode(v) for v in obj)
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    raise TypeError(f"cannot checkpoint a {type(obj).__name__}")


def _dataclass(path: str):
    module, _, qualname = path.partition(":")
    if module != _PACKAGE and not module.startswith(_PACKAGE + "."):
        raise _Mismatch(f"{path} is not a class of this package")
    cls = importlib.import_module(module)
    for name in qualname.split("."):
        cls = getattr(cls, name, None)
    if cls is None or not dataclasses.is_dataclass(cls):
        raise _Mismatch(f"{path} is not a dataclass")
    return cls


def _decode(node):
    if isinstance(node, dict) and "__ndarray__" in node:
        return node["__ndarray__"].cpu().numpy()
    if isinstance(node, dict) and "__dataclass__" in node:
        cls = _dataclass(node["__dataclass__"])
        names = {f.name for f in dataclasses.fields(cls) if f.init} - _REBUILT
        if set(node["fields"]) != names:
            raise _Mismatch(f"{cls.__qualname__} fields changed")
        return cls(**{name: _decode(v) for name, v in node["fields"].items()})
    if isinstance(node, (tuple, list)):
        return type(node)(_decode(v) for v in node)
    return node


def save(path: str, obj) -> None:
    """Write ``obj`` to ``path``: a temporary file first, then ``os.replace``,
    so a reader never sees half a file."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = f"{path}.tmp{os.getpid()}"
    try:
        torch.save({"format": FORMAT, "tree": _encode(obj)}, tmp)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def load(path: str, device, check=None):
    """The object saved at ``path``, its tensors on ``device``, or ``None``
    when there is no file, it cannot be read or decoded, or ``check(obj)``
    (the build function's test of shapes and dtypes) is false."""
    if not os.path.exists(path):
        return None
    try:
        payload = torch.load(path, map_location=device, weights_only=True)
        if not isinstance(payload, dict) or payload.get("format") != FORMAT:
            return None
        obj = _decode(payload["tree"])
        if check is not None and not check(obj):
            return None
    except (_Mismatch, AttributeError, TypeError, KeyError) + _UNREADABLE:
        return None
    return obj


def cached(path: str, compute, check, device="cpu"):
    """The object checkpointed at ``path`` (:func:`load`, its tensors on
    ``device``) or, where there is none that passes ``check``, the result
    of ``compute()``, saved there."""
    obj = load(path, device, check)
    if obj is None:
        obj = compute()
        save(path, obj)
    return obj
