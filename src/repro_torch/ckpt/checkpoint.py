"""Sharded, atomic, async checkpointing, byte-compatible with the reference's.

Layout (one directory per step), as `repro.ckpt.checkpoint` writes it:

    <dir>/step_000420/
        manifest.json           — leaf paths with shape and dtype tag, host
                                  count, host 0's file sha256, save time
        host_00000.npz          — this host's leaves, keyed by path
        host_00000.npz.sha256   — content hash sidecar (every host writes its
                                  own: host 0 cannot know remote hashes when
                                  it writes the manifest)
    <dir>/step_000420.COMPLETE   — commit marker

A save stages into `.tmp_step_NNNNNN_H/`, moves the files into
`step_NNNNNN/` and touches the marker only once every host's file exists,
so a preempted save is never restored from. The marker proves the save
finished, not that the bytes are still good: `restore_checkpoint` checks
each host file against its sha256 before it loads anything and raises
:class:`CorruptCheckpointError`; `latest_valid_step` walks markers
newest-first past corrupt or missing steps.

Leaf keys are the reference's tree paths: dict keys joined by "/", sequence
indices written as their number; None is no leaf. Dtype tags are numpy's
names ("float32", "int8", "bfloat16"), and bf16 is stored as its uint16
bits, so either package restores the other's checkpoint bitwise.

Placement (one shard a card): the counterpart of the reference's
`restore_checkpoint(shardings=)` is `restore_into(..., shardings=)`, whose
`ShardBlock`s (`repro_torch.dist.shard.cache_shardings`) narrow each
stored leaf to the rank's block of its shard axis before the in-place
copy; a placed serve saves `gather_cache`'s one-device `[L, S, ...]`
layout, so the files are the one-device serve's and the reference's.

`restore_checkpoint` builds new tensors on the devices of the struct's
leaves; `restore_into` copies into live tensors in place, so the buffers a
captured CUDA graph reads keep their addresses. `save_cache` and
`restore_cache` do the same for a reuse cache, whose host mirror of the
mode lanes (`mode_host`) is no leaf of the checkpoint: it is rebuilt from
the restored `ctrl["mode_id"]` lanes.

`AsyncCheckpointer.save` copies every leaf to the host before it returns
(the next step or graph replay overwrites the live buffers); only the disk
write runs on its thread.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
import time
from pathlib import Path
from typing import Any, Callable

import numpy as np
import torch


class CorruptCheckpointError(RuntimeError):
    """A checkpoint's bytes don't match their recorded sha256 (or the payload
    is unreadable) even though its COMPLETE marker exists."""


def _sha256_file(path: Path) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _items(tree: Any, prefix: str = ""):
    """(path, leaf) of every leaf, in the reference's order (dict keys
    sorted, as `jax.tree_util` flattens them)."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _items(tree[k], f"{prefix}{k}/")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _items(v, f"{prefix}{i}/")
    else:
        yield prefix[:-1], tree


def _map(fn: Callable[[str, Any], Any], tree: Any, prefix: str = "") -> Any:
    """`tree` with each leaf replaced by fn(path, leaf)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _map(fn, v, f"{prefix}{k}/") for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v, f"{prefix}{i}/")
                          for i, v in enumerate(tree))
    return fn(prefix[:-1], tree)


def _dtype_tag(leaf) -> str:
    if isinstance(leaf, torch.Tensor):
        return str(leaf.dtype).removeprefix("torch.")
    return str(np.asarray(leaf).dtype)


def _to_host(leaf) -> np.ndarray:
    """A leaf as the numpy array the npz stores (bf16 as its uint16 bits)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()
    return np.asarray(leaf)


def _host_copy(leaf):
    """A copy of a leaf on the host, of the leaf's dtype."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True)
    return np.array(leaf, copy=True)


def _from_host(arr: np.ndarray, meta: dict) -> torch.Tensor:
    """A stored leaf as a CPU tensor of the manifest's dtype and shape."""
    if meta["dtype"] == "bfloat16":
        t = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr, dtype=meta["dtype"]))
    return t.reshape(meta["shape"])


def save_checkpoint(
    directory: str | Path,
    step: int,
    state: Any,
    *,
    host_id: int = 0,
    n_hosts: int = 1,
) -> Path:
    directory = Path(directory)
    step_dir = directory / f"step_{step:06d}"
    tmp_dir = directory / f".tmp_step_{step:06d}_{host_id}"
    tmp_dir.mkdir(parents=True, exist_ok=True)

    arrays = {}
    manifest_leaves = {}
    for key, leaf in _items(state):
        arrays[key] = _to_host(leaf)
        manifest_leaves[key] = {"shape": list(leaf.shape),
                                "dtype": _dtype_tag(leaf)}

    host_file = tmp_dir / f"host_{host_id:05d}.npz"
    np.savez(host_file, **arrays)
    digest = _sha256_file(host_file)
    (tmp_dir / f"{host_file.name}.sha256").write_text(digest + "\n")
    if host_id == 0:
        (tmp_dir / "manifest.json").write_text(json.dumps({
            "step": step,
            "n_hosts": n_hosts,
            "leaves": manifest_leaves,
            "files": {host_file.name: digest},
            "time": time.time(),
        }, indent=1))

    # atomic publish: move the staged files into place, then commit marker
    step_dir.mkdir(parents=True, exist_ok=True)
    for f in tmp_dir.iterdir():
        os.replace(f, step_dir / f.name)
    tmp_dir.rmdir()
    expected = [step_dir / f"host_{h:05d}.npz" for h in range(n_hosts)]
    if all(p.exists() for p in expected):
        (directory / f"step_{step:06d}.COMPLETE").touch()
    return step_dir


def _complete_steps(directory: Path) -> list[int]:
    return [int(p.name.split("_")[1].split(".")[0])
            for p in directory.glob("step_*.COMPLETE")]


def latest_step(directory: str | Path) -> int | None:
    directory = Path(directory)
    if not directory.exists():
        return None
    steps = _complete_steps(directory)
    return max(steps) if steps else None


def verify_checkpoint(directory: str | Path, step: int) -> None:
    """Integrity-check one checkpoint's bytes without loading any arrays.

    Every host file must exist and match its recorded sha256 — the manifest's
    `files` entry when present (host 0), else the host's own `.sha256`
    sidecar. Raises :class:`CorruptCheckpointError` naming the first bad
    file; checkpoints with no hashes anywhere pass unverified."""
    step_dir = Path(directory) / f"step_{step:06d}"
    manifest_path = step_dir / "manifest.json"
    try:
        manifest = json.loads(manifest_path.read_text())
    except FileNotFoundError:
        raise CorruptCheckpointError(
            f"{step_dir}: manifest.json missing behind a COMPLETE marker")
    except (json.JSONDecodeError, OSError) as e:
        raise CorruptCheckpointError(
            f"{manifest_path}: unreadable manifest: {e}") from e
    hashes = manifest.get("files", {})
    for h in range(int(manifest.get("n_hosts", 1))):
        name = f"host_{h:05d}.npz"
        host_file = step_dir / name
        if not host_file.exists():
            raise CorruptCheckpointError(
                f"{host_file}: host file missing behind a COMPLETE marker")
        want = hashes.get(name)
        if want is None:
            sidecar = step_dir / f"{name}.sha256"
            if not sidecar.exists():
                continue  # no hash recorded: nothing to check against
            want = sidecar.read_text().strip()
        got = _sha256_file(host_file)
        if got != want:
            raise CorruptCheckpointError(
                f"{host_file}: sha256 mismatch (stored {want[:12]}…, "
                f"actual {got[:12]}…) — bytes changed after the save "
                f"committed")


def latest_valid_step(directory: str | Path) -> int | None:
    """Newest step that passes integrity verification: walks COMPLETE
    markers newest-first and skips any step whose payload is corrupt or
    missing (hash verification only, no array loading)."""
    directory = Path(directory)
    if not directory.exists():
        return None
    for step in sorted(_complete_steps(directory), reverse=True):
        try:
            verify_checkpoint(directory, step)
        except CorruptCheckpointError:
            continue
        return step
    return None


def _load(directory: str | Path, step: int) -> tuple[dict, dict]:
    """Verify, then read every host file: (manifest, {path: array})."""
    directory = Path(directory)
    verify_checkpoint(directory, step)
    step_dir = directory / f"step_{step:06d}"
    manifest = json.loads((step_dir / "manifest.json").read_text())
    merged: dict[str, np.ndarray] = {}
    for host_file in sorted(step_dir.glob("host_*.npz")):
        try:
            with np.load(host_file) as z:
                for key in z.files:
                    merged[key] = z[key]
        except Exception as e:  # zip-layer damage the hash check cannot see
            # on a checkpoint without hashes
            raise CorruptCheckpointError(
                f"{host_file}: unreadable payload: {e}") from e
    return manifest, merged


def _device_of(leaf) -> torch.device:
    if isinstance(leaf, torch.Tensor) and leaf.device.type != "meta":
        return leaf.device
    return torch.device("cpu")


def restore_checkpoint(directory: str | Path, step: int,
                       state_struct: Any) -> Any:
    """Load every host file and rebuild `state_struct`'s tree from it: each
    leaf takes the manifest's dtype and shape and lands on the device of
    the struct's leaf (a meta or numpy leaf: the CPU).

    Integrity is verified before any array is materialized: a hash
    mismatch, a missing host file or an unreadable payload raises
    :class:`CorruptCheckpointError`."""
    manifest, merged = _load(directory, step)
    return _map(lambda key, leaf: _from_host(
        merged[key], manifest["leaves"][key]).to(_device_of(leaf)),
        state_struct)


def restore_into(directory: str | Path, step: int, live: Any, *,
                 shardings: Any | None = None) -> Any:
    """Restore step `step` into the tensors of `live` in place (`copy_`),
    after the same checks as `restore_checkpoint`. With `shardings` (a tree
    like `live`'s of `ShardBlock`s or None), each stored leaf is first
    narrowed to its block. Every leaf of `live` must be stored with its
    shape (after the narrowing) and dtype, else ValueError (before anything
    is written). Returns `live`."""
    manifest, merged = _load(directory, step)
    blocks = dict(_items(shardings)) if shardings is not None else {}
    pairs = []
    for key, leaf in _items(live):
        meta = manifest["leaves"].get(key)
        if meta is None or key not in merged:
            raise ValueError(f"step {step}: no stored leaf {key!r}")
        shape, arr = list(meta["shape"]), merged[key]
        block = blocks.get(key)
        if block is not None and len(shape) > block.axis:
            arr = block.take(arr.reshape(shape))
            shape = list(arr.shape)
        if (list(leaf.shape) != shape
                or _dtype_tag(leaf) != meta["dtype"]):
            raise ValueError(
                f"step {step}: leaf {key!r} is {meta['dtype']}"
                f"{shape} in the checkpoint, {_dtype_tag(leaf)}"
                f"{list(leaf.shape)} live")
        pairs.append((leaf, _from_host(arr, dict(meta, shape=shape))))
    for leaf, value in pairs:
        leaf.copy_(value)
    return live


# ------------------------------------------------------------ reuse caches

def cache_state(cache: dict) -> dict:
    """A reuse cache's checkpointed leaves: every site entry without its
    host mirror `mode_host` (views of the same tensors, nothing copied)."""
    return {name: {k: v for k, v in entry.items() if k != "mode_host"}
            for name, entry in cache.items()}


def save_cache(directory: str | Path, step: int, cache: dict) -> Path:
    """`save_checkpoint` of a reuse cache (the reference's leaves)."""
    return save_checkpoint(directory, step, cache_state(cache))


def gather_cache(engine, cache: dict) -> dict:
    """The reuse cache in the one-device layout: `cache` itself, or on a
    placed engine (one shard a card) every sharded site's tensors with the
    shard axis rebuilt from every rank's lane (one all-gather a leaf, which
    every rank makes, outside any step; the host mirror `mode_host`
    stays behind)."""
    from repro_torch.core.reuse_cache import map_tensors
    from repro_torch.dist.shard import shard_axis_of

    placement = getattr(engine, "placement", None)
    if placement is None:
        return cache
    out = {}
    for name, entry in cache.items():
        entry = {k: v for k, v in entry.items() if k != "mode_host"}
        if engine.shards.get(name):
            ax = shard_axis_of(engine.stacking.get(name, 0))
            entry = map_tensors(
                lambda t, ax=ax: placement.gather_lanes(t, ax), entry)
        out[name] = entry
    return out


def restore_cache(directory: str | Path, step: int, cache: dict, *,
                  shardings: dict | None = None) -> dict:
    """Restore a reuse cache in place (`restore_into`; with `shardings`,
    from `cache_shardings`, each rank's own lane of the one-device layout),
    then rebuild each entry's `mode_host` in place from its restored
    `ctrl["mode_id"]` lanes (one device-to-host copy a site). Placed (with
    `shardings`) a rank's mirror holds every shard's lane, so the caller
    rebuilds it from every rank's lanes (`ReuseEngine.sync_mode_mirror`,
    a collective). Returns `cache`."""
    restore_into(directory, step, cache_state(cache),
                 shardings=None if shardings is None
                 else cache_state(shardings))
    if shardings is None:
        for entry in cache.values():
            entry["mode_host"][...] = entry["ctrl"]["mode_id"].cpu().numpy()
    return cache


def gc_checkpoints(directory: str | Path, keep: int = 3) -> None:
    directory = Path(directory)
    for s in sorted(_complete_steps(directory))[:-keep]:
        shutil.rmtree(directory / f"step_{s:06d}", ignore_errors=True)
        (directory / f"step_{s:06d}.COMPLETE").unlink(missing_ok=True)


class AsyncCheckpointer:
    """Writer-thread checkpointing: `save` copies the state to the host,
    hands it to a thread that writes it and returns; `wait()` joins before
    exit or before a newer save."""

    def __init__(self, directory: str | Path, *, keep: int = 3):
        self.directory = Path(directory)
        self.keep = keep
        self._thread: threading.Thread | None = None
        self._error: Exception | None = None

    def save(self, step: int, state: Any) -> None:
        self.wait()
        # on this thread, before returning: the caller's next step writes
        # the live buffers
        host_state = _map(lambda key, leaf: _host_copy(leaf), state)

        def _write():
            try:
                save_checkpoint(self.directory, step, host_state)
                gc_checkpoints(self.directory, keep=self.keep)
            except Exception as e:  # surfaced on next wait()
                self._error = e

        self._thread = threading.Thread(target=_write, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

