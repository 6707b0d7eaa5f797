"""The ``sheeprl_tpu_ckpt_v1`` checkpoint format, numpy only.

The port's copy of ``sheeprl_tpu/utils/ckpt_format.py``: a checkpoint is
one zip (numpy ``savez``) holding ``manifest`` (a JSON document stored as a
uint8 array that describes the nested structure) and one ``leaf_N.npy``
entry per array leaf.  Files written before that format (cloudpickle
blobs) raise :class:`CheckpointCorruptError`: they are never unpickled.

:func:`save_state` writes dicts, lists, tuples, ``None``, Python scalars
and numpy arrays, atomically (a tmp file, then a rename).  It writes no
per-leaf content digests (``leaf_crc``): the JAX package's
``validate_checkpoint`` skips its digest pass for such files, and the
zip's member CRCs still catch truncation.
"""

from __future__ import annotations

import collections
import json
import os
import zipfile
from pathlib import Path
from typing import Any, Dict, Optional, Sequence, Union

import numpy as np

__all__ = [
    "FORMAT_VERSION",
    "CheckpointCorruptError",
    "is_v1",
    "load_checkpoint",
    "load_state",
    "save_state",
    "validate_checkpoint",
]

FORMAT_VERSION = "sheeprl_tpu_ckpt_v1"


class CheckpointCorruptError(RuntimeError):
    """A checkpoint that cannot be read back: truncated zip, unparseable
    manifest, missing leaves, or a file that is not a v1 checkpoint."""

    def __init__(self, path: Union[str, os.PathLike], reason: str):
        self.path = str(path)
        self.reason = reason
        super().__init__(f"corrupt checkpoint {self.path}: {reason}")


_PRIMITIVES = (bool, int, float, str)


def _encode(node: Any, leaves: list) -> Any:
    """Structure spec for ``node``; array leaves appended to ``leaves``."""
    if node is None:
        return {"__t__": "none"}
    if isinstance(node, _PRIMITIVES):
        return {"__t__": "py", "v": node}
    if isinstance(node, (np.ndarray, np.generic)):
        arr = np.asarray(node)
        if arr.dtype == object:
            raise TypeError("object arrays are not checkpointable")
        leaves.append(arr)
        return {"__t__": "leaf", "i": len(leaves) - 1}
    if isinstance(node, tuple):
        return {"__t__": "tuple", "items": [_encode(x, leaves) for x in node]}
    if isinstance(node, list):
        return {"__t__": "list", "items": [_encode(x, leaves) for x in node]}
    if isinstance(node, dict):
        if not all(isinstance(k, str) for k in node):
            raise TypeError(f"non-string dict keys are not checkpointable: {list(node)[:3]}")
        return {"__t__": "dict", "items": {k: _encode(v, leaves) for k, v in node.items()}}
    raise TypeError(f"{type(node).__module__}.{type(node).__qualname__} is not checkpointable; convert it to numpy first")


def save_state(path: Union[str, os.PathLike], state: Any) -> str:
    """Write ``state`` (a host-side tree) to ``path`` atomically; ``*.ckpt.tmp``
    files left by a writer that died are removed first."""
    leaves: list = []
    tree = _encode(state, leaves)
    manifest = json.dumps({"version": FORMAT_VERSION, "tree": tree}).encode()
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(path.suffix + ".tmp")
    for orphan in path.parent.glob("*.ckpt.tmp"):
        if orphan != tmp:
            orphan.unlink(missing_ok=True)
    arrays = {f"leaf_{i}": arr for i, arr in enumerate(leaves)}
    arrays["manifest"] = np.frombuffer(manifest, dtype=np.uint8)
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)
    return str(path)


def _decode(spec: Any, get_leaf) -> Any:
    t = spec["__t__"]
    if t == "none":
        return None
    if t == "py":
        return spec["v"]
    if t == "leaf":
        arr = get_leaf(spec["i"])
        if "dtype" in spec:
            import ml_dtypes

            arr = arr.view(np.dtype(getattr(ml_dtypes, spec["dtype"])))
        return arr
    if t == "namedtuple":
        # the field layout is kept; the writer's class is not imported
        cls = collections.namedtuple(spec["cls"].partition(":")[2].split(".")[-1], spec["fields"])
        return cls(*[_decode(s, get_leaf) for s in spec["items"]])
    if t == "tuple":
        return tuple(_decode(s, get_leaf) for s in spec["items"])
    if t == "list":
        return [_decode(s, get_leaf) for s in spec["items"]]
    if t == "dict":
        return {k: _decode(s, get_leaf) for k, s in spec["items"].items()}
    raise ValueError(f"unknown node type {t!r} in checkpoint manifest")


def is_v1(path: Union[str, os.PathLike]) -> bool:
    """True when ``path`` is a ``sheeprl_tpu_ckpt_v1`` zip (vs a pickle)."""
    try:
        with open(path, "rb") as f:
            if f.read(2) != b"PK":
                return False
        with zipfile.ZipFile(path) as z:
            return "manifest.npy" in z.namelist()
    except (OSError, zipfile.BadZipFile):
        return False


def load_state(path: Union[str, os.PathLike], select: Optional[Sequence[str]] = None) -> Any:
    """Load a v1 checkpoint; ``select`` restricts to top-level dict keys
    (the other leaves are never read from disk)."""
    try:
        with np.load(path, allow_pickle=False) as npz:
            doc = json.loads(bytes(npz["manifest"]))
            if doc.get("version") != FORMAT_VERSION:
                raise ValueError(f"unknown checkpoint version {doc.get('version')!r}")
            tree = doc["tree"]
            if select is not None:
                if tree["__t__"] != "dict":
                    raise ValueError("select= needs a dict-rooted checkpoint")
                tree = {
                    "__t__": "dict",
                    "items": {k: v for k, v in tree["items"].items() if k in set(select)},
                }
            return _decode(tree, lambda i: npz[f"leaf_{i}"])
    except (zipfile.BadZipFile, EOFError, KeyError, ValueError, json.JSONDecodeError) as e:
        raise CheckpointCorruptError(path, f"{type(e).__name__}: {e}") from e


def _count_leaves(spec: Any) -> int:
    t = spec["__t__"]
    if t == "leaf":
        return 1
    if t in ("namedtuple", "tuple", "list"):
        return sum(_count_leaves(s) for s in spec["items"])
    if t == "dict":
        return sum(_count_leaves(s) for s in spec["items"].values())
    return 0


def validate_checkpoint(path: Union[str, os.PathLike]) -> Dict[str, Any]:
    """Validate a v1 checkpoint without materializing it: zip member CRCs,
    the manifest parses, and every leaf it references is present.  Raises
    :class:`CheckpointCorruptError`; returns a small summary."""
    path = Path(path)
    try:
        if path.stat().st_size == 0:
            raise CheckpointCorruptError(path, "empty file")
    except OSError as e:
        raise CheckpointCorruptError(path, f"unreadable: {e}") from e
    try:
        with zipfile.ZipFile(path) as z:
            bad = z.testzip()
            if bad is not None:
                raise CheckpointCorruptError(path, f"CRC mismatch in member {bad!r}")
            names = set(z.namelist())
            if "manifest.npy" not in names:
                raise CheckpointCorruptError(path, "no manifest (not a v1 checkpoint)")
            with z.open("manifest.npy") as f:
                manifest_arr = np.lib.format.read_array(f, allow_pickle=False)
            doc = json.loads(bytes(manifest_arr))
    except CheckpointCorruptError:
        raise
    except (zipfile.BadZipFile, EOFError, OSError, ValueError, json.JSONDecodeError) as e:
        raise CheckpointCorruptError(path, f"{type(e).__name__}: {e}") from e
    if doc.get("version") != FORMAT_VERSION:
        raise CheckpointCorruptError(path, f"unknown version {doc.get('version')!r}")
    n_leaves = _count_leaves(doc["tree"])
    missing = [i for i in range(n_leaves) if f"leaf_{i}.npy" not in names]
    if missing:
        raise CheckpointCorruptError(
            path, f"manifest references {n_leaves} leaves but members {missing[:5]} are absent"
        )
    top_keys = sorted(doc["tree"]["items"].keys()) if doc["tree"].get("__t__") == "dict" else []
    return {"version": doc["version"], "n_leaves": n_leaves, "keys": top_keys}


def load_checkpoint(path: Union[str, os.PathLike], select: Optional[Sequence[str]] = None) -> Any:
    """Validate, then load.  Anything but a v1 zip (a pre-v1 pickle
    included) raises :class:`CheckpointCorruptError`."""
    if not is_v1(path):
        raise CheckpointCorruptError(path, "not a sheeprl_tpu_ckpt_v1 zip (pre-v1 pickles are not read)")
    validate_checkpoint(path)
    return load_state(path, select=select)
