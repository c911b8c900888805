"""Sharded checkpointing: the port of ``repro/checkpoint/store.py``.

The same on-disk format, so each package reads the other's files: a JSON
manifest records each leaf's name, shape, dtype and pieces; leaves larger
than ``shard_bytes`` split along axis 0; every piece carries a CRC32 that
is verified at load (a truncated shard or flipped byte raises
``ChecksumError``; manifests written before checksums load unchecked).
Two containers share manifest and loader: numpy ``.npz`` shards and flat
``raw`` binary shards with byte offsets.

bf16 and fp8 leaves are stored as their raw bytes under the manifest
dtype names the reference writes (``bfloat16``, ``float8_e4m3fn``); numpy
has no such dtypes without ``ml_dtypes``, so the port moves them through
same-width integer views and loads leaves as CPU tensors.

Trees are nested dicts (and lists) of tensors, numpy arrays and Python
scalars, named by ``flatten_named``: ``{"ref": {"params": {"layers.0.w":
t}}}`` gives ``ref.params.layers.0.w``, the name the reference's nested
pytree of the same parameter gets.  A Python int leaf (the optimizer's
step count) is stored as int32, as the reference holds it.
"""
from __future__ import annotations

import json
import os
import zipfile
import zlib

import numpy as np
import torch

MANIFEST = "manifest.json"


class ChecksumError(RuntimeError):
    """A checkpoint/spill payload failed CRC verification at load."""


# numpy-native dtypes that np.savez round-trips by itself; anything else
# is stored as raw bytes and re-viewed on load
_NATIVE_DTYPES = ("float64", "float32", "float16", "int64", "int32", "int16",
                  "int8", "uint8", "uint16", "uint32", "uint64", "bool")
# manifest dtype name -> (torch dtype, the integer torch and numpy dtypes
# of the same width its bytes travel as)
_EXOTIC = {"bfloat16": (torch.bfloat16, torch.int16, np.int16),
           "float8_e4m3fn": (torch.float8_e4m3fn, torch.uint8, np.uint8),
           "float8_e5m2": (torch.float8_e5m2, torch.uint8, np.uint8)}
_EXOTIC_NAME = {t: name for name, (t, _, _) in _EXOTIC.items()}


def flatten_named(tree, prefix: str = "") -> dict:
    """``{dotted name: leaf}`` of a tree of dicts (keys in sorted order, as
    a pytree flattens them), lists and tuples."""
    if isinstance(tree, dict):
        items = sorted(tree.items())
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(flatten_named(v, f"{prefix}.{k}" if prefix else str(k)))
    return out


def unflatten_named(named: dict, template, prefix: str = ""):
    """The tree shaped like ``template`` whose leaves are ``named``'s."""
    if isinstance(template, dict):
        return {k: unflatten_named(named, v, f"{prefix}.{k}" if prefix
                                   else str(k)) for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        return type(template)(
            unflatten_named(named, v, f"{prefix}.{i}" if prefix else str(i))
            for i, v in enumerate(template))
    return named[prefix]


def to_host(leaf) -> tuple[np.ndarray, str]:
    """``(numpy array, manifest dtype name)`` of a leaf; bf16/fp8 tensors
    come back as their same-width integer view."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.device.type != "cpu":
            t = t.cpu()
        name = _EXOTIC_NAME.get(t.dtype)
        if name is not None:
            return t.contiguous().view(_EXOTIC[name][1]).numpy(), name
        arr = t.numpy()
        return arr, str(arr.dtype)
    if isinstance(leaf, int) and not isinstance(leaf, bool):
        arr = np.asarray(leaf, np.int32)
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _as_bytes(piece: np.ndarray) -> np.ndarray:
    """View a piece as uint8 (0-d safe: reshape first)."""
    return np.ascontiguousarray(piece).reshape(-1).view(np.uint8)


def save_checkpoint(path: str, tree, *, step: int = 0,
                    shard_bytes: int = 512 << 20, extra: dict | None = None,
                    container: str = "npz"):
    """Write ``tree`` under ``path``; ``container`` is ``"npz"`` or
    ``"raw"`` (flat binary shards with manifest byte offsets, ~3x less
    serialization work: the trace spill's).  Returns the manifest."""
    if container not in ("npz", "raw"):
        raise ValueError(f"unknown checkpoint container {container!r}")
    os.makedirs(path, exist_ok=True)
    named = flatten_named(tree)
    manifest = {"step": step, "leaves": {}, "extra": extra or {}}
    shard_id, cur_bytes, cur = 0, 0, {}
    raw_f = None

    def shard_name():
        return f"shard_{shard_id:05d}." + container

    def flush():
        nonlocal shard_id, cur_bytes, cur, raw_f
        if cur:
            np.savez(os.path.join(path, shard_name()), **cur)
            shard_id += 1
            cur_bytes, cur = 0, {}
        if raw_f is not None:
            raw_f.close()
            raw_f = None
            shard_id += 1
            cur_bytes = 0

    for name, leaf in named.items():
        arr, dtype_name = to_host(leaf)
        n = arr.nbytes
        pieces = 1
        if n > shard_bytes and arr.ndim >= 1 and arr.shape[0] > 1:
            pieces = min(arr.shape[0], -(-n // shard_bytes))
        entry = {"shape": list(arr.shape), "dtype": dtype_name, "pieces": []}
        chunks = ([arr] if arr.ndim == 0
                  else np.array_split(arr, pieces, axis=0))
        exotic = dtype_name not in _NATIVE_DTYPES
        for i, piece in enumerate(chunks):
            if cur_bytes + piece.nbytes > shard_bytes:
                flush()
            if container == "raw":
                if raw_f is None:
                    raw_f = open(os.path.join(path, shard_name()), "wb")
                data = _as_bytes(piece)
                entry["pieces"].append({"file": shard_name(),
                                        "offset": raw_f.tell(),
                                        "nbytes": int(data.nbytes),
                                        "crc": zlib.crc32(data)})
                raw_f.write(memoryview(data))
            else:
                key = f"{name}::{i}"
                cur[key] = _as_bytes(piece) if exotic else piece
                entry["pieces"].append({"file": shard_name(), "key": key,
                                        "crc": zlib.crc32(
                                            _as_bytes(piece))})
            cur_bytes += piece.nbytes
        manifest["leaves"][name] = entry
    flush()
    with open(os.path.join(path, MANIFEST), "w") as f:
        json.dump(manifest, f, indent=1)
    return manifest


def _leaf_of(pieces: list, entry: dict) -> torch.Tensor:
    """Stitch a leaf's pieces into a CPU tensor of the manifest dtype."""
    name = entry["dtype"]
    torch_dtype, _, int_dtype = _EXOTIC.get(name, (None, None, None))
    want = np.dtype(int_dtype if torch_dtype is not None else name)
    if pieces[0].dtype == np.uint8 and (torch_dtype is not None
                                        or want != np.uint8):
        # raw bytes: re-view each piece, then stitch
        pieces = [p.reshape(-1).view(want) for p in pieces]
        arr = (pieces[0] if len(pieces) == 1
               else np.concatenate(pieces)).reshape(entry["shape"])
    else:
        arr = pieces[0] if len(pieces) == 1 else np.concatenate(pieces, 0)
        if arr.dtype != want:
            arr = arr.astype(want)
        arr = arr.reshape(entry["shape"])
    t = torch.from_numpy(arr if arr.flags.writeable else arr.copy())
    return t.view(torch_dtype) if torch_dtype is not None else t


def load_checkpoint_named(path: str) -> tuple[dict[str, torch.Tensor], int,
                                              dict]:
    """Template-free restore: ``(flat {name: CPU tensor}, step, extra)``.

    Pieces whose manifest entry carries a ``crc`` are verified; a mismatch,
    a truncated shard or an unreadable container raises ``ChecksumError``.
    """
    try:
        with open(os.path.join(path, MANIFEST)) as f:
            manifest = json.load(f)
    except (json.JSONDecodeError, UnicodeDecodeError) as e:
        raise ChecksumError(f"unreadable manifest at {path}: {e}") from e
    files: dict[str, object] = {}

    def piece_of(p):
        try:
            if "offset" in p:       # raw container: byte-offset slice
                if p["file"] not in files:
                    with open(os.path.join(path, p["file"]), "rb") as f:
                        files[p["file"]] = bytearray(f.read())
                piece = np.frombuffer(files[p["file"]], np.uint8,
                                      count=p["nbytes"], offset=p["offset"])
            else:
                if p["file"] not in files:
                    files[p["file"]] = np.load(os.path.join(path, p["file"]))
                piece = files[p["file"]][p["key"]]
        except (ValueError, OSError, KeyError, zipfile.BadZipFile) as e:
            # a truncated raw shard, a torn npz, a missing key: the payload
            # is not the one the manifest describes
            raise ChecksumError(
                f"unreadable piece {p.get('key') or p.get('offset')} of "
                f"{p['file']} at {path}: {e}") from e
        if "crc" in p and zlib.crc32(_as_bytes(piece)) != p["crc"]:
            raise ChecksumError(
                f"CRC mismatch in {p['file']} at {path} "
                f"(piece {p.get('key') or p.get('offset')})")
        return piece

    named = {name: _leaf_of([piece_of(p) for p in entry["pieces"]], entry)
             for name, entry in manifest["leaves"].items()}
    return named, manifest["step"], manifest.get("extra", {})


def _place_like(t: torch.Tensor, template_leaf):
    """The checkpoint's value (and dtype) where the template leaf lives:
    a tensor on the template's device, a Python scalar for a scalar."""
    if isinstance(template_leaf, torch.Tensor):
        return t.to(template_leaf.device)
    if isinstance(template_leaf, bool):
        return bool(t)
    if isinstance(template_leaf, int):
        return int(t)
    if isinstance(template_leaf, float):
        return float(t)
    return t


def load_checkpoint(path: str, template):
    """Restore a tree saved by ``save_checkpoint`` (by either package),
    shaped and placed like ``template``: bit-exact values, the
    checkpoint's dtypes.  Returns ``(tree, step, extra)``."""
    named, step, extra = load_checkpoint_named(path)
    tmpl_named = flatten_named(template)
    placed = {name: _place_like(t, tmpl_named.get(name))
              for name, t in named.items()}
    return unflatten_named(placed, template), step, extra


def host_snapshot(tree):
    """``(host tree, wait)``: every CUDA tensor of ``tree`` copied into
    pinned host memory without waiting for the device (the loop's side of
    a background write); ``wait()`` blocks until the copies have landed.
    Other leaves pass through."""
    named = flatten_named(tree)
    events = {}
    out = {}
    for name, leaf in named.items():
        if isinstance(leaf, torch.Tensor) and leaf.device.type == "cuda":
            host = torch.empty(leaf.shape, dtype=leaf.dtype, pin_memory=True)
            host.copy_(leaf.detach(), non_blocking=True)
            out[name] = host
            if leaf.device not in events:
                events[leaf.device] = None
        else:
            out[name] = leaf
    for dev in events:
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(dev))
        events[dev] = ev

    def wait():
        for ev in events.values():
            ev.synchronize()

    return unflatten_named(out, tree), wait
