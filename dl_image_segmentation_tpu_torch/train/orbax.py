"""The JAX package's orbax checkpoints, read and written without orbax.

The JAX ``Trainer`` saves ``{"params", "opt_state", "step"}`` through
``ocp.StandardCheckpointer`` (one directory) or a ``CheckpointManager``
(``<dir>/<step>/default/``). Such a directory holds:

* ``_METADATA``: JSON; ``tree_metadata`` maps each leaf's key path to
  its keys (``key_type`` 1: a sequence index, 2: a dict key or a
  NamedTuple field) and its value (``"None"`` with ``skip_deserialize``
  for optax's empty states, else an array);
* a tensorstore OCDBT key-value store: ``manifest.ocdbt`` names the
  root B-tree node of the newest version; nodes and manifests are a
  header (magic, length, version, compression), a zstd frame and a
  CRC32C; leaf nodes hold prefix-compressed keys and values, inline or
  as (data file, offset, length) in ``d/<hash>`` or
  ``ocdbt.process_<i>/d/<hash>`` (tensorstore's "OCDBT on-disk format");
* per leaf, a zarr v2 array in that store: ``<a.b.c>/.zarray`` (dtype,
  shape, chunks, zstd compressor) and one chunk per grid cell,
  ``<a.b.c>/i.j.k``.

:func:`read_checkpoint` rebuilds the tree as numpy arrays, tuples, dicts
and None, with the port's own zstd decoder (``storage/zstd.py``) and
CRC32C (``records/crc32c.py``); :func:`write_checkpoint` writes a
single-process store that orbax restores (Raw-block zstd frames, one
chunk per array). gs:// and s3:// checkpoints are staged through a
temporary directory, as the JAX package stages them.
"""

from __future__ import annotations

import itertools
import json
import math
import os
import re
import shutil
import struct
import tempfile
import time
import uuid
from typing import Dict, List, Optional, Tuple

import numpy as np

from .. import storage
from ..records.crc32c import crc32c_native
from ..storage.zstd import compress_raw, decompress

__all__ = ["OrbaxFormatError", "all_steps", "is_checkpoint",
           "latest_step", "read_checkpoint", "read_tree", "step_dirs",
           "step_path", "write_checkpoint"]

_MANIFEST_MAGIC = 0x0CDB3A2A
_NODE_MAGIC = 0x0CDB20DE
_MAX_MANIFEST = 1 << 26
# the config orbax's stores carry (tensorstore's defaults for orbax)
_MAX_INLINE = 1024
_MAX_NODE = 100_000_000
_HANDLER = ("orbax.checkpoint._src.handlers.standard_checkpoint_handler."
            "StandardCheckpointHandler")


class OrbaxFormatError(ValueError):
    """A checkpoint that is corrupt or uses a feature the reader lacks."""


class _Cursor:
    """Bounds-checked reads from one decoded node or manifest."""

    def __init__(self, data: bytes, what: str):
        self.data, self.pos, self.what = data, 0, what

    def take(self, n: int) -> bytes:
        if n < 0 or self.pos + n > len(self.data):
            raise OrbaxFormatError(f"{self.what} is truncated")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def byte(self) -> int:
        return self.take(1)[0]

    def varint(self) -> int:
        value = shift = 0
        for _ in range(10):
            b = self.byte()
            value |= (b & 0x7F) << shift
            if b < 0x80:
                return value
            shift += 7
        raise OrbaxFormatError(f"{self.what} has a varint over 64 bits")

    def varints(self, n: int) -> List[int]:
        return [self.varint() for _ in range(n)]


def _unwrap(raw: bytes, magic: int, what: str, max_size: int) -> bytes:
    """The payload of a manifest or node: checks magic, length, version
    and CRC32C, and decodes its zstd frame."""
    if len(raw) < 18 or struct.unpack(">I", raw[:4])[0] != magic:
        raise OrbaxFormatError(f"{what} has no OCDBT magic")
    if struct.unpack("<Q", raw[4:12])[0] != len(raw):
        raise OrbaxFormatError(f"{what} has the wrong length")
    if struct.unpack("<I", raw[-4:])[0] != crc32c_native(raw[:-4]):
        raise OrbaxFormatError(f"{what} fails its CRC32C")
    c = _Cursor(raw[:-4], what)
    c.pos = 12
    if c.varint() != 0:
        raise OrbaxFormatError(f"{what} has an unknown format version")
    method = c.varint()
    body = raw[c.pos:-4]
    if method == 0:
        return body
    if method == 1:
        return decompress(body, max_size)
    raise OrbaxFormatError(f"{what} uses compression method {method}")


def _file_table(c: _Cursor) -> List[str]:
    """A node's or manifest's data file table: prefix-compressed paths
    relative to the store's root."""
    n = c.varint()
    prefix = [0] + c.varints(n - 1) if n else []
    suffix = c.varints(n)
    c.varints(n)  # base path lengths: part of the path itself
    paths, prev = [], b""
    for p, s in zip(prefix, suffix):
        if p > len(prev):
            raise OrbaxFormatError(f"{c.what}: bad data file path prefix")
        prev = prev[:p] + c.take(s)
        path = prev.decode()
        if path.startswith("/") or ".." in path.split("/"):
            raise OrbaxFormatError(f"{c.what}: data file {path!r} lies "
                                   "outside the store")
        paths.append(path)
    return paths


def _keys(c: _Cursor, n: int, interior: bool) -> Tuple[List[bytes], List[int]]:
    prefix = [0] + c.varints(n - 1) if n else []
    suffix = c.varints(n)
    common = c.varints(n) if interior else []
    keys, prev = [], b""
    for p, s in zip(prefix, suffix):
        if p > len(prev):
            raise OrbaxFormatError(f"{c.what}: bad key prefix length")
        prev = prev[:p] + c.take(s)
        keys.append(prev)
    return keys, common


class _Store:
    """The newest version of an OCDBT store: key -> inline bytes or
    (data file, offset, length)."""

    def __init__(self, root: str):
        self.root = root
        with open(os.path.join(root, "manifest.ocdbt"), "rb") as f:
            data = _unwrap(f.read(), _MANIFEST_MAGIC, "manifest.ocdbt",
                           _MAX_MANIFEST)
        c = _Cursor(data, "manifest.ocdbt")
        c.take(16)  # uuid
        if c.varint() != 0:
            raise OrbaxFormatError("numbered OCDBT manifests are not read")
        c.varint()  # max_inline_value_bytes
        self.max_node = c.varint()
        c.byte()  # version_tree_arity_log2
        method = c.varint()
        if method == 1:
            c.take(4)  # zstd level
        elif method != 0:
            raise OrbaxFormatError(f"OCDBT compression method {method}")
        files = _file_table(c)
        n = c.varint()
        if n == 0:
            raise OrbaxFormatError("manifest.ocdbt holds no version")
        cols = [c.varints(n), [c.byte() for _ in range(n)]]
        cols += [c.varints(n) for _ in range(6)]
        # the inline versions end with the newest one
        _, height, fid, off, length = (col[-1] for col in cols[:5])
        self.entries: Dict[bytes, object] = {}
        if length:
            if fid >= len(files):
                raise OrbaxFormatError("manifest names a missing data file")
            self._node(files[fid], off, length, height, b"")

    def _node(self, path, off, length, height, prefix):
        what = f"OCDBT node {path}@{off}"
        with open(os.path.join(self.root, path), "rb") as f:
            f.seek(off)
            raw = f.read(length)
        if len(raw) != length:
            raise OrbaxFormatError(f"{what} is truncated")
        c = _Cursor(_unwrap(raw, _NODE_MAGIC, what, self.max_node), what)
        if c.byte() != height:
            raise OrbaxFormatError(f"{what} has the wrong height")
        files = _file_table(c)
        n = c.varint()
        keys, common = _keys(c, n, height > 0)

        def file_of(fid):
            if fid >= len(files):
                raise OrbaxFormatError(f"{what} names a missing data file")
            return files[fid]
        if height > 0:
            fids, offs, lens = (c.varints(n) for _ in range(3))
            c.varints(3 * n)  # statistics
            for k, cp, fid, o, ln in zip(keys, common, fids, offs, lens):
                self._node(file_of(fid), o, ln, height - 1,
                           prefix + k[:cp])
            return
        lens = c.varints(n)
        kinds = c.varints(n)
        indirect = [i for i in range(n) if kinds[i] == 1]
        if any(k > 1 for k in kinds):
            raise OrbaxFormatError(f"{what} has an unknown value kind")
        fids = c.varints(len(indirect))
        offs = c.varints(len(indirect))
        for i, fid, o in zip(indirect, fids, offs):
            self.entries[prefix + keys[i]] = (file_of(fid), o, lens[i])
        for i in range(n):
            if kinds[i] == 0:
                self.entries[prefix + keys[i]] = c.take(lens[i])
        if c.pos != len(c.data):
            raise OrbaxFormatError(f"{what} has trailing bytes")

    def get(self, key: str) -> Optional[bytes]:
        ref = self.entries.get(key.encode())
        if ref is None or isinstance(ref, bytes):
            return ref
        path, off, length = ref
        with open(os.path.join(self.root, path), "rb") as f:
            f.seek(off)
            data = f.read(length)
        if len(data) != length:
            raise OrbaxFormatError(f"value {key!r} is truncated in {path}")
        return data


def _fill(meta: dict):
    fill = meta.get("fill_value")
    if fill is None:
        return 0
    if isinstance(fill, str):  # "NaN", "Infinity", "-Infinity"
        return float(fill.replace("Infinity", "inf"))
    return fill


def _read_array(store: _Store, name: str) -> np.ndarray:
    """A zarr v2 array of the store, assembled from its chunk grid."""
    raw = store.get(f"{name}/.zarray")
    if raw is None:
        raise OrbaxFormatError(f"the checkpoint has no array {name!r}")
    meta = json.loads(raw)
    if meta.get("zarr_format") != 2 or meta.get("filters"):
        raise OrbaxFormatError(f"{name}: only zarr v2 arrays without "
                               "filters are read")
    try:
        dtype = np.dtype(meta["dtype"])
    except TypeError as e:
        raise OrbaxFormatError(f"{name}: dtype {meta['dtype']!r}") from e
    shape, chunks = tuple(meta["shape"]), tuple(meta["chunks"])
    order = meta.get("order", "C")
    comp = meta.get("compressor")
    if comp is not None and comp.get("id") != "zstd":
        raise OrbaxFormatError(f"{name}: compressor {comp.get('id')!r}")
    sep = meta.get("dimension_separator", ".")
    if len(chunks) != len(shape) or any(ch <= 0 for ch in chunks):
        raise OrbaxFormatError(f"{name}: chunks {chunks} for shape {shape}")
    out = np.full(shape, _fill(meta), dtype)
    nbytes = math.prod(chunks) * dtype.itemsize
    grid = [range(-(-s // ch)) for s, ch in zip(shape, chunks)]
    for idx in itertools.product(*grid):
        key = sep.join(map(str, idx)) if shape else "0"
        data = store.get(f"{name}/{key}")
        if data is None:
            continue  # a chunk equal to the fill value
        if comp is not None:
            data = decompress(data, nbytes)
        if len(data) != nbytes:
            raise OrbaxFormatError(f"{name}/{key} holds {len(data)} bytes, "
                                   f"not {nbytes}")
        chunk = np.frombuffer(data, dtype).reshape(chunks, order=order)
        dst = tuple(slice(i * ch, min((i + 1) * ch, s))
                    for i, ch, s in zip(idx, chunks, shape))
        out[dst] = chunk[tuple(slice(0, d.stop - d.start) for d in dst)]
    return out


def _staged(path: str, fn):
    """``fn(local path)``: a gs:// or s3:// prefix is downloaded into a
    temporary directory first."""
    if not storage.is_remote(path):
        return fn(path)
    tmp = tempfile.mkdtemp(prefix="dlseg-torch-orbax-")
    try:
        if storage.download_dir(path, tmp) == 0:
            raise FileNotFoundError(f"no checkpoint at {path}")
        return fn(tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def is_checkpoint(path: str) -> bool:
    """Whether ``path`` (local, gs:// or s3://) holds an orbax
    checkpoint's ``_METADATA``."""
    return storage.exists(storage.join(path, "_METADATA")) \
        if storage.is_remote(path) \
        else os.path.isfile(os.path.join(path, "_METADATA"))


def _tree(root: str):
    with open(os.path.join(root, "_METADATA")) as f:
        meta = json.load(f)
    if not meta.get("use_ocdbt", False) or meta.get("use_zarr3", False):
        raise OrbaxFormatError("only OCDBT checkpoints of zarr v2 arrays "
                               "are read")
    store = _Store(root)
    nested: dict = {}
    for entry in meta["tree_metadata"].values():
        keys = entry["key_metadata"]
        value = entry["value_metadata"]
        if value.get("skip_deserialize") or value["value_type"] == "None":
            leaf = None
        elif value["value_type"] in ("jax.Array", "np.ndarray", "scalar"):
            leaf = _read_array(store, ".".join(k["key"] for k in keys))
            if value["value_type"] == "scalar":
                leaf = leaf[()]
        else:
            raise OrbaxFormatError(
                f"leaf {[k['key'] for k in keys]} has value type "
                f"{value['value_type']!r}")
        node = nested
        for i, k in enumerate(keys):
            slot = (int(k["key_type"]), k["key"])
            if i == len(keys) - 1:
                node[slot] = leaf
            else:
                node = node.setdefault(slot, {})

    def build(node):
        if not isinstance(node, dict):
            return node
        types = {t for t, _ in node}
        if types == {1}:
            items = sorted(node.items(), key=lambda kv: int(kv[0][1]))
            if [int(k) for (_, k), _ in items] != list(range(len(items))):
                raise OrbaxFormatError("a sequence in the tree has gaps")
            return tuple(build(v) for _, v in items)
        if types - {2}:
            raise OrbaxFormatError(f"unknown key types {sorted(types)}")
        return {k: build(v) for (_, k), v in node.items()}
    return build(nested)


def read_tree(path: str):
    """The whole tree of the orbax checkpoint at ``path`` (local, gs:// or
    s3://): numpy arrays, dicts (dict keys and NamedTuple fields),
    tuples (sequences) and None (optax's empty states)."""
    return _staged(path, _tree)


def read_checkpoint(path: str) -> dict:
    """``{"params", "opt_state", "step"}`` of a checkpoint that the JAX
    ``Trainer`` wrote, as numpy arrays (see :func:`read_tree`)."""
    tree = read_tree(path)
    missing = {"params", "opt_state", "step"} - set(tree)
    if missing:
        raise OrbaxFormatError(f"{path} is not a Trainer checkpoint: it "
                               f"lacks {sorted(missing)}")
    return tree


# -- managed directories ----------------------------------------------------
def all_steps(directory: str) -> List[int]:
    """The steps of a local ``CheckpointManager`` directory that orbax
    finished: ``<step>/_CHECKPOINT_METADATA`` and
    ``<step>/default/_METADATA`` both present (orbax's temporary
    directories and a step cut short are not counted)."""
    if not os.path.isdir(directory):
        return []
    return sorted(
        int(n) for n in os.listdir(directory) if re.fullmatch(r"\d+", n)
        and os.path.isfile(os.path.join(directory, n, "_CHECKPOINT_METADATA"))
        and os.path.isfile(os.path.join(directory, n, "default", "_METADATA")))


def step_dirs(directory: str) -> List[int]:
    """Every step directory of a local ``CheckpointManager`` directory as
    orbax 0.11 counts them when it prunes: each directory with an integer
    name, finished or not (orbax's temporary directories carry a suffix;
    ``<step>.pt`` files are not directories)."""
    if not os.path.isdir(directory):
        return []
    return sorted(int(n) for n in os.listdir(directory)
                  if re.fullmatch(r"\d+", n)
                  and os.path.isdir(os.path.join(directory, n)))


def latest_step(directory: str) -> Optional[int]:
    """The newest finished step of a managed directory, or None."""
    steps = all_steps(directory)
    return steps[-1] if steps else None


def step_path(directory: str, step: int) -> str:
    """The checkpoint of ``step`` in a managed directory."""
    return os.path.join(directory, str(int(step)), "default")


# -- writer -----------------------------------------------------------------
def _varint(v: int) -> bytes:
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _varints(values) -> bytes:
    return b"".join(_varint(v) for v in values)


def _wrap(magic: int, payload: bytes) -> bytes:
    """Header, one Raw-block zstd frame, CRC32C."""
    body = b"\x00\x01" + compress_raw(payload)  # version 0, zstd
    head = struct.pack(">I", magic) + struct.pack("<Q", 12 + len(body) + 4)
    raw = head + body
    return raw + struct.pack("<I", crc32c_native(raw))


def _table(paths: List[str]) -> bytes:
    out = _varint(len(paths))
    enc = [p.encode() for p in paths]
    common = [len(os.path.commonprefix([a, b])) for a, b in zip(enc, enc[1:])]
    out += _varints(common)
    out += _varints(len(p) - c for p, c in zip(enc, [0] + common))
    out += _varints(0 for _ in enc)
    return out + b"".join(p[c:] for p, c in zip(enc, [0] + common))


def _leaves(tree, keys=()):
    """(keys, value) per leaf; a key is (name, key_type)."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, keys + ((str(k), 2),))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _leaves(v, keys + ((str(i), 1),))
    else:
        yield keys, tree


def _write_store(root: str, values: Dict[bytes, bytes]) -> None:
    """A single-version OCDBT store holding ``values``: the indirect
    values and one leaf node in one data file."""
    name = f"d/{uuid.uuid4().hex}"
    keys = sorted(values)
    blob = bytearray()
    offsets = {}
    for k in keys:
        if len(values[k]) > _MAX_INLINE:
            offsets[k] = len(blob)
            blob += values[k]
    indirect = [k for k in keys if k in offsets]
    common = [len(os.path.commonprefix([a, b])) for a, b in zip(keys, keys[1:])]
    node = bytes([0]) + _table([name] if indirect else [])
    node += _varint(len(keys)) + _varints(common)
    node += _varints(len(k) - c for k, c in zip(keys, [0] + common))
    node += b"".join(k[c:] for k, c in zip(keys, [0] + common))
    node += _varints(len(values[k]) for k in keys)
    node += _varints(int(k in offsets) for k in keys)
    node += _varints(0 for _ in indirect) + _varints(offsets[k]
                                                     for k in indirect)
    node += b"".join(values[k] for k in keys if k not in offsets)
    node = _wrap(_NODE_MAGIC, node)
    node_off = len(blob)
    os.makedirs(os.path.join(root, "d"), exist_ok=True)
    with open(os.path.join(root, name), "wb") as f:
        f.write(bytes(blob) + node)
    manifest = uuid.uuid4().bytes + _varints([0, _MAX_INLINE, _MAX_NODE])
    manifest += bytes([4]) + _varint(1) + struct.pack("<i", 0)
    manifest += _table([name]) + _varint(1)
    manifest += _varints([1]) + bytes([0]) + _varints(
        [0, node_off, len(node), len(keys), len(node), len(blob)])
    manifest += struct.pack("<Q", time.time_ns()) + b"\x00"
    with open(os.path.join(root, "manifest.ocdbt"), "wb") as f:
        f.write(_wrap(_MANIFEST_MAGIC, manifest))


def _write_item(root: str, tree) -> None:
    os.makedirs(root, exist_ok=True)
    values: Dict[bytes, bytes] = {}
    tree_meta = {}
    for keys, value in _leaves(tree):
        names = [k for k, _ in keys]
        entry = {"key_metadata": [{"key": k, "key_type": t} for k, t in keys]}
        if value is None:
            entry["value_metadata"] = {"value_type": "None",
                                       "skip_deserialize": True}
        else:
            arr = np.asarray(value)  # tobytes() is C order
            if arr.dtype.byteorder == ">":
                arr = arr.astype(arr.dtype.newbyteorder("<"))
            name = ".".join(names)
            zarray = {"chunks": list(arr.shape),
                      "compressor": {"id": "zstd", "level": 1},
                      "dimension_separator": ".", "dtype": arr.dtype.str,
                      "fill_value": None, "filters": None, "order": "C",
                      "shape": list(arr.shape), "zarr_format": 2}
            values[f"{name}/.zarray".encode()] = json.dumps(
                zarray, separators=(",", ":"), sort_keys=True).encode()
            chunk = "0" if arr.ndim == 0 else ".".join("0" for _ in arr.shape)
            values[f"{name}/{chunk}".encode()] = compress_raw(arr.tobytes())
            entry["value_metadata"] = {"value_type": "np.ndarray",
                                       "skip_deserialize": False}
        tree_meta[str(tuple(names))] = entry
    _write_store(root, values)
    with open(os.path.join(root, "_METADATA"), "w") as f:
        json.dump({"tree_metadata": tree_meta, "use_ocdbt": True,
                   "use_zarr3": False,
                   "store_array_data_equal_to_fill_value": True,
                   "custom_metadata": None}, f)


def _checkpoint_metadata(path: str, handlers, t0: int) -> None:
    with open(os.path.join(path, "_CHECKPOINT_METADATA"), "w") as f:
        json.dump({"item_handlers": handlers, "metrics": {},
                   "performance_metrics": {}, "init_timestamp_nsecs": t0,
                   "commit_timestamp_nsecs": time.time_ns(),
                   "custom_metadata": {}}, f)


def write_checkpoint(path: str, tree, managed: bool = False) -> str:
    """Write ``tree`` (nested dicts, tuples/lists, None and numpy arrays;
    the JAX ``Trainer``'s ``{"params", "opt_state", "step"}``) as an
    orbax checkpoint that ``ocp.StandardCheckpointer`` restores bitwise.
    With ``managed``, ``path`` is a ``CheckpointManager`` directory and
    the tree is written as step ``int(tree["step"])``
    (``<path>/<step>/default/``). The checkpoint is built in a temporary
    directory and renamed into place (local) or uploaded (gs://,
    s3://). Returns the checkpoint's path."""
    t0 = time.time_ns()
    final = storage.join(path, str(int(np.asarray(tree["step"])))) \
        if managed else path
    remote = storage.is_remote(final)
    parent = tempfile.mkdtemp(prefix="dlseg-torch-orbax-") if remote \
        else os.path.dirname(os.path.abspath(final))
    os.makedirs(parent, exist_ok=True)
    tmp = os.path.join(parent, f"{storage.basename(final)}"
                               f".orbax-checkpoint-tmp-{t0}")
    try:
        if managed:
            _write_item(os.path.join(tmp, "default"), tree)
            _checkpoint_metadata(tmp, {"default": _HANDLER}, t0)
        else:
            _write_item(tmp, tree)
            _checkpoint_metadata(tmp, _HANDLER, t0)
        if remote:
            storage.upload_dir(tmp, final)
        else:
            if os.path.exists(final):
                raise FileExistsError(f"{final} already exists")
            os.replace(tmp, final)
    finally:
        shutil.rmtree(parent if remote else tmp, ignore_errors=True)
    result = storage.join(final, "default") if managed else final
    return result if remote else os.path.abspath(result)
