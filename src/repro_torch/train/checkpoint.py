"""Fault-tolerant checkpointing with ZipFlow-compressed shards: the
reference's ``train/checkpoint.py``, file for file.

Layout:  <dir>/step_<N>/
            manifest.json        -- leaf names, shapes, dtypes, hashes, sizes
            leaf_<i>.npz         -- compressed buffers for that leaf
         <dir>/LATEST            -- atomic pointer (tmp + rename)

A tree is nested dicts (keys in sorted order), lists and tuples, with numpy
arrays, tensors or scalars at the leaves; a leaf is named by its path, as
``jax.tree_util.tree_flatten_with_path`` names the reference's
("0/layers/attn/wq", "1/mu/embed/embedding", "1/step").  Float leaves are
byte-planed and the high (exponent) byte goes through the port's ANS codec
when that is smaller; integer leaves through bitpack; anything else is stored
raw ("raw2").  So a checkpoint of either package restores in the other to the
same arrays.  A bf16 leaf (numpy has no bf16 here) is stored as the reference
stores its own: two raw bytes an element under dtype "bfloat16"; the
reference cannot read such a leaf back (ROADMAP §3), the port reads it
through a 16-bit view.  Encoding and decoding are host numpy
(``plan.encode``, the codecs' ``decode_np``), as the reference's are.

Durability: every file is written to a tmp name and renamed (atomic on
POSIX); LATEST flips only after the whole step directory is in place, so a
crash mid-write never corrupts the restore path.  Content hashes are checked
on load.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
from typing import Any

import numpy as np
import torch

from repro_torch.core import plan as plan_mod
from repro_torch.core.registry import get as get_codec

_FLOAT_PLAN = plan_mod.make_plan("ans")          # applied to the exponent byte plane
_INT_PLAN = plan_mod.make_plan("bitpack")
BF16 = "bfloat16"


def _leaf_paths(tree, prefix: str = "") -> list[tuple[str, Any]]:
    if tree is None:
        return []
    if isinstance(tree, dict):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    elif isinstance(tree, (list, tuple)):
        items = [(str(i), v) for i, v in enumerate(tree)]
    else:
        return [(prefix, tree)]
    return [leaf for k, v in items
            for leaf in _leaf_paths(v, f"{prefix}/{k}" if prefix else k)]


def _unflatten(like, leaves):
    if like is None:
        return None
    if isinstance(like, dict):
        return {k: _unflatten(like[k], leaves) for k in sorted(like)}
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(v, leaves) for v in like)
    return next(leaves)


def _host(leaf) -> tuple[np.ndarray, str]:
    """A leaf as a numpy array and the dtype its manifest names."""
    if torch.is_tensor(leaf):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16).view("V2"), BF16
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _json_meta(meta: dict) -> bytes:
    """Codec meta as JSON, minus ndarray-valued host planning data -- the
    decoders read only the scalar structural fields."""
    return json.dumps({k: v for k, v in meta.items()
                       if not isinstance(v, np.ndarray)}).encode()


def _encode_leaf(arr: np.ndarray) -> dict[str, np.ndarray | bytes | str]:
    """Byte-plane + ZipFlow-encode one array; returns an npz-ready dict."""
    raw = np.ascontiguousarray(arr)
    if raw.dtype.kind == "f":
        b = raw.view(np.uint8).reshape(-1, raw.dtype.itemsize)
        planes = {}
        # high byte (exponent-heavy) -> ANS; the other planes stored raw
        hi = b[:, -1].copy()
        enc = plan_mod.encode(_FLOAT_PLAN, hi)
        if enc.compressed_nbytes < hi.nbytes:
            planes["hi_codec"] = "ans"
            for k, v in plan_mod.flat_buffers(enc).items():
                planes[f"hi.{k}"] = v
            planes["hi_meta"] = _json_meta(enc.meta)
        else:
            planes["hi_codec"] = "raw"
            planes["hi.raw"] = hi
        planes["rest"] = b[:, :-1].copy()
        return planes
    if raw.dtype.kind in "iu" and raw.size:
        enc = plan_mod.encode(_INT_PLAN, raw.reshape(-1))
        if enc.compressed_nbytes < raw.nbytes:
            out = {f"bp.{k}": v for k, v in plan_mod.flat_buffers(enc).items()}
            out["hi_codec"] = "bitpack"
            out["bp_meta"] = _json_meta(enc.meta)
            return out
    return {"hi_codec": "raw2", "raw": raw}


def _decode_leaf(files: dict, shape, dtype: str) -> torch.Tensor:
    codec = str(files["hi_codec"])
    if codec == "raw2":
        raw = np.asarray(files["raw"])
        if dtype == BF16:
            return torch.from_numpy(raw.view(np.int16).reshape(shape).copy()).view(
                torch.bfloat16)
        return torch.from_numpy(raw.reshape(shape).astype(np.dtype(dtype)))
    dt = np.dtype(dtype)
    n = int(np.prod(shape)) if shape else 1
    if codec == "bitpack":
        meta = json.loads(bytes(files["bp_meta"]))
        bufs = {k[len("bp.root."):]: np.asarray(v) for k, v in files.items()
                if k.startswith("bp.root.")}
        vals = get_codec("bitpack").decode_np(bufs, meta, n, dt)
        return torch.from_numpy(np.array(vals.reshape(shape)))
    # float byte-plane path
    rest = np.asarray(files["rest"])
    if codec == "ans":
        meta = json.loads(bytes(files["hi_meta"]))
        bufs = {k[len("hi.root."):]: np.asarray(v) for k, v in files.items()
                if k.startswith("hi.root.")}
        hi = get_codec("ans").decode_np(bufs, meta, rest.shape[0], np.uint8)
    else:
        hi = np.asarray(files["hi.raw"])
    b = np.concatenate([rest, hi[:, None]], axis=1)
    return torch.from_numpy(b.reshape(-1).view(dt).reshape(shape))


def _atomic_write(path: str, write_fn) -> None:
    tmp = path + ".tmp"
    write_fn(tmp)
    os.replace(tmp, path)


def _write_npz(path: str, enc: dict) -> None:
    with open(path, "wb") as f:
        np.savez(f, **enc)


def _write_text(path: str, text: str) -> None:
    with open(path, "w") as f:
        f.write(text)


def save(ckpt_dir: str, step: int, tree, extra: dict | None = None) -> str:
    """Save a tree checkpoint; returns the step directory."""
    step_dir = os.path.join(ckpt_dir, f"step_{step:08d}")
    os.makedirs(step_dir + ".tmp", exist_ok=True)
    manifest = {"step": step, "leaves": {}, "extra": extra or {}}
    for i, (name, leaf) in enumerate(_leaf_paths(tree)):
        arr, dtype = _host(leaf)
        enc = _encode_leaf(arr)
        fname = f"leaf_{i:05d}.npz"
        fpath = os.path.join(step_dir + ".tmp", fname)
        _atomic_write(fpath, lambda t: _write_npz(t, enc))
        with open(fpath, "rb") as f:
            h = hashlib.sha256(f.read()).hexdigest()[:16]
        manifest["leaves"][name] = {
            "file": fname, "shape": list(arr.shape), "dtype": dtype, "sha": h,
            "raw_bytes": int(arr.nbytes), "stored_bytes": int(os.path.getsize(fpath))}
    _atomic_write(os.path.join(step_dir + ".tmp", "manifest.json"),
                  lambda t: _write_text(t, json.dumps(manifest, indent=1)))
    if os.path.isdir(step_dir):
        shutil.rmtree(step_dir)
    os.replace(step_dir + ".tmp", step_dir)
    _atomic_write(os.path.join(ckpt_dir, "LATEST"),
                  lambda t: _write_text(t, f"step_{step:08d}"))
    return step_dir


def latest_step(ckpt_dir: str) -> int | None:
    try:
        with open(os.path.join(ckpt_dir, "LATEST")) as f:
            name = f.read().strip()
        return int(name.split("_")[1])
    except (FileNotFoundError, IndexError, ValueError):
        return None


def restore(ckpt_dir: str, tree_like, step: int | None = None):
    """Restore into the structure of ``tree_like`` (its leaves' names; the
    shapes and dtypes are the manifest's) -> (tree of CPU tensors, step,
    extra)."""
    step = latest_step(ckpt_dir) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    step_dir = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(step_dir, "manifest.json")) as f:
        manifest = json.load(f)
    leaves = []
    for name, _ in _leaf_paths(tree_like):
        info = manifest["leaves"][name]
        fpath = os.path.join(step_dir, info["file"])
        with open(fpath, "rb") as f:
            blob = f.read()
        if hashlib.sha256(blob).hexdigest()[:16] != info["sha"]:
            raise IOError(f"checkpoint corruption in {fpath}: hash mismatch")
        with np.load(fpath, allow_pickle=False) as z:
            files = dict(z)
        leaves.append(_decode_leaf(files, tuple(info["shape"]), info["dtype"]))
    return _unflatten(tree_like, iter(leaves)), step, manifest.get("extra", {})


def compression_report(ckpt_dir: str, step: int | None = None) -> dict:
    step = latest_step(ckpt_dir) if step is None else step
    with open(os.path.join(ckpt_dir, f"step_{step:08d}", "manifest.json")) as f:
        man = json.load(f)
    raw = sum(v["raw_bytes"] for v in man["leaves"].values())
    stored = sum(v["stored_bytes"] for v in man["leaves"].values())
    return {"raw_bytes": raw, "stored_bytes": stored, "ratio": raw / max(stored, 1)}
