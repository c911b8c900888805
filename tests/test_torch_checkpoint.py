"""Checkpoints cross between the packages: the JAX package's
``save_checkpoint`` is read by the port's ``load_checkpoint`` and the port's
by the JAX package's, bit for bit, for f32, bf16, e4m3, int32 and 0-d
leaves, a leaf split over shards, and both containers (``npz``, ``raw``).
The port rejects a truncated or bit-flipped piece with ``ChecksumError``
and loads a manifest written before checksums."""
import json
import os

import ml_dtypes
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.checkpoint import store as jstore  # noqa: E402
from repro_torch.checkpoint import store as tstore  # noqa: E402

CONTAINERS = ("npz", "raw")
SHARD_BYTES = 1024          # the "split" leaf (64 x 16 f32) spans 4 shards


def _numpy_tree():
    """The reference-side tree: numpy leaves (ml_dtypes for bf16/e4m3)."""
    rng = np.random.default_rng(0)
    return {
        "params": {
            "f32": rng.standard_normal((3, 5)).astype(np.float32),
            "bf16": rng.standard_normal((4, 6)).astype(ml_dtypes.bfloat16),
            "layers": [{"e4m3": (rng.standard_normal(8) * 4).astype(
                ml_dtypes.float8_e4m3fn)}],
            "split": rng.standard_normal((64, 16)).astype(np.float32),
            "scalar": np.asarray(0.75, np.float32),
        },
        "opt": {"step": np.asarray(7, np.int32),
                "ids": np.arange(9, dtype=np.int32)},
    }


def _torch_tree():
    """The same tree as the port holds it: tensors, the step a Python int."""
    def conv(x):
        a = np.asarray(x)
        if a.dtype == ml_dtypes.bfloat16:
            return torch.from_numpy(a.view(np.int16).copy()).view(
                torch.bfloat16)
        if a.dtype == ml_dtypes.float8_e4m3fn:
            return torch.from_numpy(a.view(np.uint8).copy()).view(
                torch.float8_e4m3fn)
        return torch.from_numpy(a.copy())
    tree = _numpy_tree()
    out = {"params": {k: conv(v) for k, v in tree["params"].items()
                      if k != "layers"},
           "opt": {"step": 7, "ids": conv(tree["opt"]["ids"])}}
    out["params"]["layers"] = [{"e4m3": conv(
        tree["params"]["layers"][0]["e4m3"])}]
    return out


def _bytes(leaf) -> bytes:
    if isinstance(leaf, torch.Tensor):
        t = leaf.contiguous()
        return t.view(torch.uint8).numpy().tobytes() if t.dim() else \
            t.reshape(1).view(torch.uint8).numpy().tobytes()
    if isinstance(leaf, int):
        return np.asarray(leaf, np.int32).tobytes()
    return np.ascontiguousarray(np.asarray(leaf)).tobytes()


def _dtype_name(leaf) -> str:
    if isinstance(leaf, (torch.Tensor, int)):
        return tstore.to_host(leaf)[1]
    return str(np.asarray(leaf).dtype)


def _assert_same(a: dict, b: dict):
    assert set(a) == set(b)
    for name in a:
        assert _dtype_name(a[name]) == _dtype_name(b[name]), name
        assert tuple(np.shape(a[name])) == tuple(np.shape(b[name])), name
        assert _bytes(a[name]) == _bytes(b[name]), name


@pytest.mark.parametrize("container", CONTAINERS)
def test_jax_checkpoint_loads_in_the_port(tmp_path, container):
    path = str(tmp_path / "ck")
    jstore.save_checkpoint(path, _numpy_tree(), step=5, extra={"tag": "j"},
                           container=container, shard_bytes=SHARD_BYTES)
    named, step, extra = tstore.load_checkpoint_named(path)
    assert step == 5 and extra == {"tag": "j"}
    _assert_same(named, tstore.flatten_named(_torch_tree()))
    # placed like a template: tensors stay tensors, the step an int
    tree, _, _ = tstore.load_checkpoint(path, _torch_tree())
    assert tree["opt"]["step"] == 7 and isinstance(tree["opt"]["step"], int)
    assert tree["params"]["bf16"].dtype == torch.bfloat16
    assert tree["params"]["layers"][0]["e4m3"].dtype == torch.float8_e4m3fn
    _assert_same(tstore.flatten_named(tree),
                 tstore.flatten_named(_torch_tree()))


@pytest.mark.parametrize("container", CONTAINERS)
def test_port_checkpoint_loads_in_jax(tmp_path, container):
    path = str(tmp_path / "ck")
    man = tstore.save_checkpoint(path, _torch_tree(), step=9,
                                 extra={"tag": "t"}, container=container,
                                 shard_bytes=SHARD_BYTES)
    assert len(man["leaves"]["params.split"]["pieces"]) > 1
    named, step, extra = jstore.load_checkpoint_named(path)
    assert step == 9 and extra == {"tag": "t"}
    _assert_same(named, jstore.flatten_named(_numpy_tree()))


@pytest.mark.parametrize("container", CONTAINERS)
def test_both_packages_write_the_same_manifest(tmp_path, container):
    """Same leaves in the same order, same dtype names, shapes, pieces
    and CRCs (and so the same shard files)."""
    pj, pt = str(tmp_path / "j"), str(tmp_path / "t")
    mj = jstore.save_checkpoint(pj, _numpy_tree(), container=container,
                                shard_bytes=SHARD_BYTES)
    mt = tstore.save_checkpoint(pt, _torch_tree(), container=container,
                                shard_bytes=SHARD_BYTES)
    assert mj["leaves"].keys() == mt["leaves"].keys()
    for name, ej in mj["leaves"].items():
        assert ej == mt["leaves"][name], name


def _first_shard(path):
    return os.path.join(path, sorted(f for f in os.listdir(path)
                                     if f.startswith("shard_"))[0])


@pytest.mark.parametrize("container", CONTAINERS)
@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("damage", ["truncate", "flip"])
def test_damaged_piece_raises_checksum_error(tmp_path, container, writer,
                                            damage):
    path = str(tmp_path / "ck")
    if writer == "jax":
        jstore.save_checkpoint(path, _numpy_tree(), container=container)
    else:
        tstore.save_checkpoint(path, _torch_tree(), container=container)
    shard = _first_shard(path)
    size = os.path.getsize(shard)
    with open(shard, "r+b") as f:
        if damage == "truncate":
            f.truncate(size // 2)
        else:
            f.seek(size // 2)
            chunk = f.read(4)
            f.seek(size // 2)
            f.write(bytes(b ^ 0xFF for b in chunk))
    with pytest.raises(tstore.ChecksumError):
        tstore.load_checkpoint_named(path)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_pre_checksum_manifest_loads_unchecked(tmp_path, writer):
    path = str(tmp_path / "old")
    if writer == "jax":
        jstore.save_checkpoint(path, _numpy_tree())
    else:
        tstore.save_checkpoint(path, _torch_tree())
    mpath = os.path.join(path, tstore.MANIFEST)
    with open(mpath) as f:
        man = json.load(f)
    for entry in man["leaves"].values():
        for piece in entry["pieces"]:
            piece.pop("crc", None)
    with open(mpath, "w") as f:
        json.dump(man, f)
    named, _, _ = tstore.load_checkpoint_named(path)
    _assert_same(named, tstore.flatten_named(_torch_tree()))


def test_host_snapshot_is_a_copy():
    """The background writers' host copies: later changes to the source
    do not reach them (on the CPU the tensors pass through, and the
    steps never update a state in place)."""
    src = {"w": torch.arange(4.0), "s": 3}
    host, wait = tstore.host_snapshot(src)
    wait()
    assert torch.equal(host["w"], torch.arange(4.0)) and host["s"] == 3
