"""Atomic checkpointing with auto-resume, the JAX package's layout::

    <dir>/step_00000123/
        shard_00000.npz        the leaves as ``leaf_<i>`` arrays
        MANIFEST.json          leaf paths, shapes, dtypes, host count,
                               written LAST -> presence == complete

Writes go to ``step_XXX.tmp.<pid>`` and are renamed into place only after
the manifest is fsynced, so a killed writer never leaves a checkpoint
that ``latest_step`` would pick up.  A tree is nested dicts, lists,
tuples and NamedTuples of torch tensors, numpy arrays or scalars; its
leaf paths are the reference's ``jax.tree_util.keystr`` strings (dict
keys sorted, ``['key']``, ``[i]``, ``.field``), so either package reads
the other's checkpoints.  bf16 is stored as its uint16 bits (torch's
``view``; the manifest names ``bfloat16``).
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step",
           "AsyncCheckpointer", "gc_checkpoints"]

_MANIFEST = "MANIFEST.json"


def _flatten(tree, path: str, out: list) -> None:
    if isinstance(tree, dict):
        for k in sorted(tree):
            _flatten(tree[k], f"{path}[{k!r}]", out)
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for name, v in zip(tree._fields, tree):
            _flatten(v, f"{path}.{name}", out)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            _flatten(v, f"{path}[{i}]", out)
    else:
        out.append((path, tree))


def _unflatten(like, leaves):
    if isinstance(like, dict):
        return {k: _unflatten(like[k], leaves) for k in sorted(like)}
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*(_unflatten(v, leaves) for v in like))
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(v, leaves) for v in like)
    return next(leaves)


def _paths_and_leaves(tree) -> tuple[list[str], list[Any]]:
    flat: list = []
    _flatten(tree, "", flat)
    return [p for p, _ in flat], [v for _, v in flat]


def _to_host(v, snapshot: bool = False) -> tuple[np.ndarray, str]:
    """A leaf as the numpy array stored on disk, and its dtype's name;
    ``snapshot``: never sharing memory with ``v``."""
    if isinstance(v, torch.Tensor):
        v = v.detach()
        if snapshot and v.device.type == "cpu":
            v = v.clone()
        if v.dtype == torch.bfloat16:
            return v.cpu().view(torch.int16).numpy().view(np.uint16), \
                "bfloat16"
        a = v.cpu().numpy()
        return a, a.dtype.name
    a = np.array(v) if snapshot else np.asarray(v)
    return a, a.dtype.name


def _from_disk(a: np.ndarray, dtype_name: str, device) -> torch.Tensor:
    if dtype_name == "bfloat16":
        t = torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))
    return t.to(device)


def _step_dir(directory: str, step: int) -> str:
    return os.path.join(directory, f"step_{step:08d}")


def _write(directory: str, step: int, paths: list, host: list,
           metadata: Optional[dict], process_index: int,
           keep_last: Optional[int]) -> str:
    os.makedirs(directory, exist_ok=True)
    final = _step_dir(directory, step)
    tmp = f"{final}.tmp.{os.getpid()}"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    np.savez(os.path.join(tmp, f"shard_{process_index:05d}.npz"),
             **{f"leaf_{i}": a for i, (a, _) in enumerate(host)})
    manifest = {
        "step": step,
        "paths": paths,
        "shapes": [list(a.shape) for a, _ in host],
        "dtypes": [name for _, name in host],
        "process_count": 1,
        "metadata": metadata or {},
    }
    with open(os.path.join(tmp, _MANIFEST), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    if keep_last is not None:
        gc_checkpoints(directory, keep_last)
    return final


def save_checkpoint(directory: str, step: int, tree, *,
                    metadata: Optional[dict] = None, process_index: int = 0,
                    keep_last: Optional[int] = None) -> str:
    """Write ``tree`` atomically; returns the checkpoint path."""
    paths, leaves = _paths_and_leaves(tree)
    return _write(directory, step, paths, [_to_host(v) for v in leaves],
                  metadata, process_index, keep_last)


def latest_step(directory: str) -> Optional[int]:
    """Newest step with a complete manifest (torn .tmp writes ignored)."""
    if not os.path.isdir(directory):
        return None
    steps = []
    for name in os.listdir(directory):
        if name.startswith("step_") and "." not in name and os.path.exists(
                os.path.join(directory, name, _MANIFEST)):
            try:
                steps.append(int(name.split("_")[1]))
            except ValueError:
                continue
    return max(steps) if steps else None


def restore_checkpoint(directory: str, tree_like, *,
                       step: Optional[int] = None, device=None):
    """Restore into the structure of ``tree_like`` (its leaves may be
    tensors of any device, meta included, arrays or scalars).  Returns
    (step, tree) with torch tensors on ``device`` (default: each
    ``tree_like`` tensor's own device, the CPU for meta and non-tensor
    leaves)."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(
                f"no complete checkpoint under {directory}")
    cdir = _step_dir(directory, step)
    with open(os.path.join(cdir, _MANIFEST)) as f:
        manifest = json.load(f)
    paths, like = _paths_and_leaves(tree_like)
    if paths != manifest["paths"]:
        raise ValueError(
            "checkpoint tree structure mismatch:\n"
            f"  saved    : {manifest['paths'][:5]}... "
            f"({len(manifest['paths'])} leaves)\n"
            f"  restoring: {paths[:5]}... ({len(paths)} leaves)")
    leaves = []
    with np.load(os.path.join(cdir, "shard_00000.npz")) as data:
        for i, ref in enumerate(like):
            dev = device
            if dev is None:
                dev = (ref.device if isinstance(ref, torch.Tensor)
                       and ref.device.type != "meta" else "cpu")
            leaves.append(_from_disk(data[f"leaf_{i}"],
                                     manifest["dtypes"][i], dev))
    return step, _unflatten(tree_like, iter(leaves))


def gc_checkpoints(directory: str, keep_last: int) -> None:
    """Keep the newest ``keep_last`` complete checkpoints; clear torn
    temporary directories."""
    steps = sorted(
        int(n.split("_")[1]) for n in os.listdir(directory)
        if n.startswith("step_") and "." not in n
        and os.path.exists(os.path.join(directory, n, _MANIFEST)))
    for s in steps[:-keep_last] if keep_last > 0 else []:
        shutil.rmtree(_step_dir(directory, s), ignore_errors=True)
    for n in os.listdir(directory):
        if ".tmp." in n:
            shutil.rmtree(os.path.join(directory, n), ignore_errors=True)


class AsyncCheckpointer:
    """Overlap checkpoint writes with the next training steps.

    ``save`` copies every leaf to host numpy before it returns -- the
    optimizer updates parameters in place, so a writer holding device
    tensors would write the next step's values -- then a daemon thread
    writes the files; ``wait`` joins before the next save or at
    shutdown, so at most one write is in flight and none is dropped.
    """

    def __init__(self, directory: str, keep_last: Optional[int] = 3):
        self.directory = directory
        self.keep_last = keep_last
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def save(self, step: int, tree, metadata: Optional[dict] = None) -> None:
        self.wait()
        paths, leaves = _paths_and_leaves(tree)
        host = [_to_host(v, snapshot=True) for v in leaves]

        def _run():
            try:
                _write(self.directory, step, paths, host, metadata, 0,
                       self.keep_last)
            except BaseException as e:  # surfaced on the next wait()
                self._error = e

        self._thread = threading.Thread(target=_run, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err
