"""Pytree checkpointing: .npz payload + JSON treedef manifest (port of
``repro/checkpoint/checkpoint.py``, in the same file format).

Path-keyed (not order-keyed) so checkpoints survive adding/removing
state fields; supports partial restore and dtype/shape validation.
Leaves are keyed by their pytree path exactly as the reference keys
them (``a/1/0`` for lists and tuples, ``b/.y`` for namedtuple fields,
``c/d`` for dicts), so a checkpoint written by either package loads in
the other. The reference flattens dicts in sorted key order and torch
in insertion order: ``restore`` matches leaves by key, never by
position.

Writes are **atomic**: both files land via temp-file + ``fsync`` +
``os.replace`` in the target directory, so a crash mid-save can never
leave a torn checkpoint — the previous one survives intact (this is
what makes the PS runtime's crash-consistent snapshots in
``repro_torch.ps.recovery`` safe). ``restore`` cross-validates the JSON
manifest against the npz payload before touching any leaf and fails
with errors that name the file and the offending leaf.

Tensors are written from ``.detach().cpu()``. numpy has no bfloat16:
a bf16 leaf is stored as its raw 2-byte words (numpy's ``V2``) with
``bfloat16`` in the manifest, the bytes the reference writes, so
``load_arrays`` returns them unchanged in either package; ``restore``
refuses such a leaf, as the reference's does.

The manifest can carry an arbitrary JSON-serializable ``extra``
payload next to the leaves (``save(..., extra=...)`` /
``load_extra``) — the runtime snapshot layer stores all its
non-array state (rng states, clock, membership intervals, ...) there.
"""
from __future__ import annotations

import json
import os
import tempfile
from typing import Any, Dict, Optional

import numpy as np
import torch
from torch.utils import _pytree as pytree

BF16 = "bfloat16"


def _flatten_with_paths(tree) -> Dict[str, Any]:
    flat = {}
    for path, leaf in pytree.tree_flatten_with_path(tree)[0]:
        key = "/".join(
            str(getattr(p, "key", getattr(p, "idx", p))) for p in path)
        flat[key] = leaf
    return flat


def _to_numpy(leaf):
    """(numpy array, manifest dtype) of one leaf."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.dtype("V2")), BF16
        a = t.numpy()
    else:
        a = np.asarray(leaf)
    return a, str(a.dtype)


def _atomic_replace(target: str, write_fn) -> None:
    """Write via a temp file in the target's directory + os.replace —
    the only crash-safe publish on POSIX (rename within a filesystem
    is atomic; a crash leaves either the old file or the new one)."""
    d = os.path.dirname(target) or "."
    fd, tmp = tempfile.mkstemp(dir=d, prefix=os.path.basename(target) + ".",
                               suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            write_fn(f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, target)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def save(path: str, tree, step: Optional[int] = None,
         extra: Optional[Dict] = None) -> None:
    """Atomically write ``path + ".npz"`` (arrays) and ``path + ".json"``
    (manifest). The npz lands first, the manifest second — a reader
    that sees the manifest is guaranteed a complete matching payload
    (restore cross-validates anyway). ``extra`` is an arbitrary
    JSON-serializable blob stored in the manifest."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    arrays, dtypes = {}, {}
    for k, v in _flatten_with_paths(tree).items():
        arrays[k], dtypes[k] = _to_numpy(v)
    _atomic_replace(path + ".npz", lambda f: np.savez(f, **arrays))
    manifest = {
        "step": step,
        "leaves": {k: {"shape": list(a.shape), "dtype": dtypes[k]}
                   for k, a in arrays.items()},
    }
    if extra is not None:
        manifest["extra"] = extra
    _atomic_replace(
        path + ".json",
        lambda f: f.write(json.dumps(manifest, indent=1).encode()))


def _load_manifest(path: str) -> Dict:
    mpath = path + ".json"
    try:
        with open(mpath) as f:
            text = f.read()
    except FileNotFoundError:
        raise FileNotFoundError(
            f"checkpoint manifest {mpath!r} not found — was this "
            f"checkpoint written by repro_torch.checkpoint.save?") from None
    try:
        manifest = json.loads(text)
    except json.JSONDecodeError as e:
        raise ValueError(f"checkpoint manifest {mpath!r} is corrupt JSON "
                         f"({e}) — torn write or wrong file") from e
    if not isinstance(manifest, dict) or "leaves" not in manifest \
            or not isinstance(manifest["leaves"], dict):
        raise ValueError(f"checkpoint manifest {mpath!r} has no 'leaves' "
                         f"table — not a repro_torch.checkpoint manifest")
    return manifest


def _load_validated(path: str):
    """Load the npz and cross-validate it against the manifest: every
    manifest leaf must exist in the npz with the recorded shape, and
    vice versa. Catches torn/mismatched checkpoint halves before any
    caller reads a leaf."""
    manifest = _load_manifest(path)
    npath = path + ".npz"
    try:
        data = np.load(npath, allow_pickle=False)
    except FileNotFoundError:
        raise FileNotFoundError(
            f"checkpoint payload {npath!r} not found (manifest "
            f"{path + '.json'!r} exists) — torn checkpoint") from None
    except Exception as e:
        raise ValueError(f"checkpoint payload {npath!r} is unreadable "
                         f"({e}) — truncated or corrupt npz") from e
    leaves = manifest["leaves"]
    for key, meta in leaves.items():
        if key not in data.files:
            raise ValueError(
                f"checkpoint {path!r}: manifest lists leaf {key!r} but the "
                f"npz payload does not contain it — torn or mixed-up "
                f"checkpoint halves")
        shape = tuple(data[key].shape)
        want = tuple(meta.get("shape", ()))
        if shape != want:
            raise ValueError(
                f"checkpoint {path!r}: leaf {key!r} has npz shape {shape} "
                f"but the manifest recorded {want} — torn or mixed-up "
                f"checkpoint halves")
    for key in data.files:
        if key not in leaves:
            raise ValueError(
                f"checkpoint {path!r}: npz contains leaf {key!r} absent "
                f"from the manifest — torn or mixed-up checkpoint halves")
    return data, manifest


def restore(path: str, like_tree) -> Any:
    """Restore into the structure of ``like_tree`` (path-matched): every
    leaf comes back as a tensor with the dtype and device of
    ``like_tree``'s leaf (a non-tensor leaf: its numpy dtype, on the
    CPU)."""
    data, manifest = _load_validated(path)
    flat_like = _flatten_with_paths(like_tree)
    missing = [k for k in flat_like if k not in data.files]
    if missing:
        raise KeyError(
            f"checkpoint {path!r} is missing leaves required by the "
            f"restore target: {missing[:5]}{'...' if len(missing) > 5 else ''}")
    leaves_like, treedef = pytree.tree_flatten(like_tree)
    out = []
    for key, ref in zip(flat_like, leaves_like):
        arr = data[key]
        shape = tuple(ref.shape) if hasattr(ref, "shape") \
            else np.shape(ref)
        if tuple(arr.shape) != shape:
            raise ValueError(
                f"checkpoint {path!r}: leaf {key!r} has shape "
                f"{tuple(arr.shape)} but the restore target expects "
                f"{shape}")
        if manifest["leaves"][key].get("dtype") == BF16 \
                or arr.dtype.kind == "V":
            raise ValueError(
                f"checkpoint {path!r}: leaf {key!r} is stored as bfloat16 "
                f"(raw 2-byte words, numpy dtype {arr.dtype}), which "
                f"restore cannot cast; read its bytes with load_arrays")
        if isinstance(ref, torch.Tensor):
            out.append(torch.as_tensor(arr).to(dtype=ref.dtype,
                                                device=ref.device))
        else:
            out.append(torch.as_tensor(
                np.asarray(arr, np.asarray(ref).dtype)))
    return pytree.tree_unflatten(out, treedef)


def load_arrays(path: str) -> Dict[str, np.ndarray]:
    """All leaves of a checkpoint as a flat {path: array} dict,
    manifest-validated (no ``like_tree`` needed — used by the PS
    snapshot layer whose leaf set is data-dependent)."""
    data, _ = _load_validated(path)
    return {k: data[k] for k in data.files}


def load_extra(path: str) -> Optional[Dict]:
    """The manifest's ``extra`` payload (None when absent)."""
    return _load_manifest(path).get("extra")


def load_step(path: str) -> Optional[int]:
    return _load_manifest(path).get("step")
