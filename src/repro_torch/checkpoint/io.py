"""Pytree checkpointing with a versioned, checksummed manifest
(``repro.checkpoint.io``, format version 2, byte for byte).

One file per checkpoint: ``{version, meta, leaves: {keystr(path): {dtype,
shape, crc32, data}}}`` in MessagePack, written atomically (``.tmp`` +
fsync + rename) so a crash mid-write never leaves a half-checkpoint under
the final name.  Every leaf carries a CRC32 of its raw bytes; loading
verifies the format version and every checksum and raises
:class:`CheckpointError`, never a raw codec or numpy error, on truncated,
corrupt or version-mismatched files.

The codec is the port's own (``_msgpack.py``): the file is the one
``msgpack.packb(payload, use_bin_type=True)`` would write.  Leaf keys are
``jax.tree_util.keystr`` strings (``['params']['layers'][0]...``) in the
port's tree order (dict keys sorted, as ``jax.tree_util`` sorts them; so
``'10'`` comes before ``'2'``).  A leaf's dtype travels by name
(``float32``, ``bfloat16``); ``bfloat16`` bytes go through an int16 view.

The writer streams leaf by leaf (a device tensor is copied to the host one
leaf at a time), and the reader takes the leaves from a memory map, copying
each into a CPU tensor it owns.
"""
from __future__ import annotations

import mmap
import os
import zlib
from typing import Any, Dict, Tuple

import numpy as np
import torch

from repro_torch.checkpoint import _msgpack as M
from repro_torch.utils.tree import tree_flatten_with_keys, tree_unflatten

FORMAT_VERSION = 2

# dtype names (numpy's, as the JAX package writes them) <-> torch dtypes
_DTYPES = {"float32": torch.float32, "float64": torch.float64,
           "float16": torch.float16, "bfloat16": torch.bfloat16,
           "int8": torch.int8, "int16": torch.int16, "int32": torch.int32,
           "int64": torch.int64, "uint8": torch.uint8,
           "uint16": torch.uint16, "uint32": torch.uint32,
           "uint64": torch.uint64, "bool": torch.bool,
           "complex64": torch.complex64}
_NAMES = {v: k for k, v in _DTYPES.items()}


class CheckpointError(RuntimeError):
    """A checkpoint file is unreadable, truncated, corrupt, from a
    different format version, or inconsistent with the restore target."""


def _host_leaf(x) -> Tuple[str, np.ndarray]:
    """(dtype name, a C-contiguous host array holding the leaf's bytes)."""
    if isinstance(x, torch.Tensor):
        t = x.detach()
        name = _NAMES.get(t.dtype)
        if name is None:
            raise TypeError(f"no checkpoint dtype for {t.dtype}")
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        return name, _c_order(t.cpu().numpy())
    a = _c_order(np.asarray(x))
    return a.dtype.name, a


def _c_order(a: np.ndarray) -> np.ndarray:
    # not np.ascontiguousarray: it turns a 0-d array into shape (1,)
    return a if a.flags.c_contiguous else a.copy(order="C")


def _write_leaf(write, key: str, x) -> None:
    name, a = _host_leaf(x)
    data = memoryview(a.reshape(-1).view(np.uint8))
    M.pack(key, write)
    write(M.map_header(4))
    for field, value in (("dtype", name), ("shape", list(a.shape)),
                         ("crc32", zlib.crc32(data))):
        M.pack(field, write)
        M.pack(value, write)
    M.pack("data", write)
    M.pack(data, write)


def save_pytree(path: str, tree: Any, metadata: dict | None = None):
    """Atomically write ``tree`` (+ MessagePack-able ``metadata``) to
    ``path``.  Leaves are tensors (any device) or numpy arrays."""
    leaves, _ = tree_flatten_with_keys(tree)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        write = f.write
        write(M.map_header(3))
        for field, value in (("version", FORMAT_VERSION),
                             ("meta", metadata or {})):
            M.pack(field, write)
            M.pack(value, write)
        M.pack("leaves", write)
        write(M.map_header(len(leaves)))
        for key, x in leaves:
            _write_leaf(write, key, x)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def _unpack_leaf(name: str, d) -> torch.Tensor:
    try:
        dtype, shape = d["dtype"], d["shape"]
        crc, data = d["crc32"], d["data"]
    except (KeyError, TypeError) as e:
        raise CheckpointError(
            f"leaf {name!r}: malformed manifest entry ({e})") from e
    if not isinstance(data, (bytes, memoryview)):
        raise CheckpointError(f"leaf {name!r}: data is not a byte string")
    if zlib.crc32(data) != crc:
        raise CheckpointError(
            f"leaf {name!r}: CRC32 mismatch (corrupt leaf bytes)")
    if dtype not in _DTYPES:
        raise CheckpointError(f"leaf {name!r}: unknown dtype {dtype!r}")
    try:
        out = torch.empty([int(s) for s in shape], dtype=_DTYPES[dtype])
    except (TypeError, ValueError, RuntimeError) as e:
        raise CheckpointError(f"leaf {name!r}: bad shape {shape!r}") from e
    dst = out.reshape(-1).view(torch.uint8).numpy()
    if dst.nbytes != len(data):
        raise CheckpointError(
            f"leaf {name!r}: {len(data)} bytes for shape {shape} of "
            f"{dtype}")
    dst[:] = np.frombuffer(data, np.uint8)
    return out


def _plain(x):
    """A manifest value with every bin view copied out into ``bytes``."""
    if isinstance(x, memoryview):
        return bytes(x)
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_plain(v) for v in x]
    return x


def _release(x) -> None:
    """Release every bin view of a manifest (the memory map can then
    close)."""
    if isinstance(x, memoryview):
        x.release()
    elif isinstance(x, dict):
        for v in x.values():
            _release(v)
    elif isinstance(x, list):
        for v in x:
            _release(v)


def load_manifest(path: str) -> Tuple[dict, Dict[str, torch.Tensor]]:
    """Read + verify a checkpoint: ``(meta, {keystr: CPU tensor})``.

    Checks the format version and every leaf's CRC32; any failure raises
    :class:`CheckpointError` with the offending leaf/file named."""
    try:
        f = open(path, "rb")
    except OSError as e:
        raise CheckpointError(f"cannot read checkpoint {path!r}: {e}") from e
    with f:
        try:
            mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
        except (OSError, ValueError) as e:  # an empty file cannot be mapped
            raise CheckpointError(
                f"{path!r}: truncated or corrupt msgpack payload ({e})"
            ) from None
    try:
        payload, err = None, None
        try:
            payload = M.unpackb(mm, zero_copy=True)
        except M.UnpackError as e:
            err = f"{path!r}: truncated or corrupt msgpack payload ({e})"
        if err is not None:
            raise CheckpointError(err)
        if not isinstance(payload, dict):
            raise CheckpointError(f"{path!r}: not a checkpoint manifest")
        version = payload.get("version")
        if version != FORMAT_VERSION:
            raise CheckpointError(
                f"{path!r}: checkpoint format version {version!r} != "
                f"supported {FORMAT_VERSION}")
        leaves = payload.get("leaves")
        if not isinstance(leaves, dict):
            raise CheckpointError(f"{path!r}: manifest has no leaves table")
        out = {name: _unpack_leaf(name, d) for name, d in leaves.items()}
        return _plain(payload.get("meta", {})), out
    finally:
        _release(payload)
        try:
            mm.close()
        except BufferError:  # a view still alive: the map closes with it
            pass


def load_pytree(path: str, template: Any):
    """Load into the structure of ``template``, a tree of tensors
    (shape-checked; each leaf takes its template leaf's dtype and
    device)."""
    _, leaves = load_manifest(path)
    flat, treedef = tree_flatten_with_keys(template)
    out = []
    for key, tleaf in flat:
        if key not in leaves:
            raise CheckpointError(f"checkpoint missing leaf {key!r}")
        arr = leaves[key]
        if tuple(arr.shape) != tuple(tleaf.shape):
            raise CheckpointError(f"shape mismatch at {key!r}: "
                                  f"{tuple(arr.shape)} vs "
                                  f"{tuple(tleaf.shape)}")
        out.append(arr.to(device=tleaf.device, dtype=tleaf.dtype))
    return tree_unflatten(treedef, out)
