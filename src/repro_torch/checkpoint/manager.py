"""Async, integrity-checked checkpointing: the port of the reference's
``checkpoint/manager.py``, in its format.

One ``step_<k>/`` directory per checkpoint holds ``arrays.npz`` (the tree
flattened under ``/``-joined key paths, exactly as the reference's
``_flatten`` names them) and ``manifest.json`` (the tree's structure,
keys, step, sha256 of the npz, user metadata). A checkpoint written by
either package restores in the other. ``save`` copies every leaf to the
host before it returns (a consistent snapshot: the optimizer later writes
the tensors in place), and the write can run on a background thread, fenced
by the next ``save`` or ``wait``; ``keep_last`` prunes. numpy holds no
bfloat16, so a bfloat16 leaf raises instead of being written as another
type (the masters and moments are float32). The arrays are saved whole,
so a checkpoint restores onto any mesh: ``restore`` puts each leaf on its
``like_tree`` leaf's device, or with ``shardings`` (a tree of
``sharding.plan.Sharding``, as ``Plan.param_shardings`` gives it) places it
as a ``DTensor`` on the current mesh (``ft.elastic.rescale``).

A tree of ``DTensor`` s (the sharded train step's state) is saved whole
too: each leaf is gathered (``sharding.spmd.full_tensor``, a collective
that every rank of its mesh joins). With ``across_ranks`` every rank of
the process group keeps a manager of the same directory and calls it at
the same steps: each gathers every leaf, rank 0 alone copies them to the
host, writes and prunes, ``wait`` holds every rank until rank 0's write
is done, and ``latest_step`` is rank 0's reading on every rank. The
format is the one-process one, so a checkpoint moves between world
sizes.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.sharding import spmd


def _items(tree, prefix=()):
    """(key path, leaf) pairs in the reference's flattening order: dict
    keys sorted, sequences by index."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _items(tree[k], prefix + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _items(v, prefix + (str(i),))
    else:
        yield "/".join(prefix), tree


def _dict_leaves(tree):
    """The leaves of a nested dict in sorted key order (a leaf may be a
    tuple, as a ``Sharding`` is)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _dict_leaves(tree[k])
    else:
        yield tree


def _host(key: str, leaf) -> np.ndarray:
    """A host copy of one leaf (a CPU tensor's numpy view would follow
    later writes)."""
    if not isinstance(leaf, torch.Tensor):
        return np.array(leaf)
    if leaf.dtype == torch.bfloat16:
        raise TypeError(f"checkpoint leaf {key!r} is bfloat16, which numpy "
                        f"cannot hold")
    t = leaf.detach()
    return t.numpy().copy() if t.device.type == "cpu" else t.cpu().numpy()


def _flatten(tree, keep: bool = True) -> Dict[str, np.ndarray]:
    """Host copies of the leaves by key path, each ``DTensor`` gathered
    first; with ``keep`` False the gathers run (a rank must join each) and
    nothing is copied."""
    flat = {}
    for k, v in _items(tree):
        v = spmd.full_tensor(v)
        if keep:
            flat[k] = _host(k, v)
        del v
    return flat


def _structure(tree) -> str:
    """The tree's shape in the reference's ``PyTreeDef`` notation."""
    def walk(t):
        if isinstance(t, dict):
            return "{" + ", ".join(f"{k!r}: {walk(t[k])}"
                                   for k in sorted(t)) + "}"
        if isinstance(t, (list, tuple)):
            inner = ", ".join(walk(v) for v in t)
            return f"[{inner}]" if isinstance(t, list) else f"({inner})"
        return "*"
    return f"PyTreeDef({walk(tree)})"


def _unflatten(like, leaves):
    if isinstance(like, dict):
        return {k: _unflatten(like[k], leaves) for k in sorted(like)}
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(v, leaves) for v in like)
    return next(leaves)


def _sha256(path: str, block: int = 1 << 26) -> str:
    """The file's sha256, read in blocks (a full-width checkpoint is ~15
    GB; the reference reads it whole)."""
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(block), b""):
            h.update(chunk)
    return h.hexdigest()


def _place(a: np.ndarray, sh):
    """The saved array ``a`` as a ``DTensor`` on ``sh.mesh`` with
    ``sh.placements``: this rank's shard (each ``Shard(d)`` of a mesh
    dimension splits dimension d into that dimension's size, in mesh order,
    as ``DTensor`` lays shards out) is cut on the host and copied alone to
    the device; a rank outside the mesh holds an empty shard."""
    from torch.distributed.tensor import DTensor, Shard
    full = torch.from_numpy(a)
    coord = sh.mesh.get_coordinate()
    local = full
    if coord is None:
        local = full.new_empty(0)
    else:
        for i, p in enumerate(sh.placements):
            if isinstance(p, Shard):
                local = local.chunk(sh.mesh.size(i), dim=p.dim)[coord[i]]
    local = local.to(sh.mesh.device_type, copy=True,
                     memory_format=torch.contiguous_format)
    return DTensor.from_local(local, sh.mesh, sh.placements, run_check=False,
                              shape=full.shape, stride=full.stride())


class CheckpointManager:
    def __init__(self, directory: str, keep_last: int = 3,
                 async_save: bool = True, across_ranks: bool = False):
        """``across_ranks``: one manager on each rank of the initialised
        process group, rank 0 the writer (module docstring)."""
        self.dir = directory
        self.keep_last = keep_last
        self.async_save = async_save
        self.across_ranks = across_ranks
        self.writer = not across_ranks or dist.get_rank() == 0
        self._thread: Optional[threading.Thread] = None
        os.makedirs(directory, exist_ok=True)

    # --- save ---------------------------------------------------------------
    def save(self, step: int, tree, metadata: Optional[Dict[str, Any]] = None):
        self.wait()  # fence the previous async save
        flat = _flatten(tree, self.writer)  # the host copy happens now
        if not self.writer:
            return
        args = (step, flat, _structure(tree), metadata or {})
        if self.async_save:
            self._thread = threading.Thread(target=self._write, args=args,
                                            daemon=True)
            self._thread.start()
        else:
            self._write(*args)

    def _write(self, step: int, flat, structure: str, metadata):
        """``step_<k>/`` from the host copies, renamed into place whole,
        then the oldest pruned."""
        path = os.path.join(self.dir, f"step_{step:08d}")
        tmp = path + ".tmp"
        os.makedirs(tmp, exist_ok=True)
        npz_path = os.path.join(tmp, "arrays.npz")
        np.savez(npz_path, **flat)
        manifest = {
            "step": step,
            "treedef": structure,
            "keys": sorted(flat.keys()),
            "sha256": _sha256(npz_path),
            "time": time.time(),
            "metadata": metadata,
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f, indent=1)
        if os.path.exists(path):
            shutil.rmtree(path)
        os.rename(tmp, path)
        self._prune()

    def wait(self):
        """Until the last save is written (across ranks: on every rank)."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self.across_ranks:
            dist.barrier()

    def _prune(self):
        steps = self.all_steps()
        for s in steps[: -self.keep_last]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"),
                          ignore_errors=True)

    # --- restore --------------------------------------------------------------
    def all_steps(self):
        out = []
        for d in os.listdir(self.dir):
            if d.startswith("step_") and not d.endswith(".tmp"):
                out.append(int(d.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        """The newest step on disk (across ranks: rank 0's reading, the
        same on every rank)."""
        steps = self.all_steps() if self.writer else None
        latest = steps[-1] if steps else None
        if self.across_ranks:
            box = [latest]
            dist.broadcast_object_list(box, src=0)
            latest = box[0]
        return latest

    def restore(self, like_tree, step: Optional[int] = None,
                shardings=None, verify: bool = True) -> Tuple[Any, int]:
        """Restore into the structure of ``like_tree``: each leaf a tensor
        of the saved dtype on its ``like_tree`` leaf's device (the CPU for
        a leaf that is no tensor), or with ``shardings`` a ``DTensor`` on
        its leaf's mesh and placements (:func:`_place`: each rank reads the
        whole array on the host and copies only its own shard to its
        device; no collective runs)."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        path = os.path.join(self.dir, f"step_{step:08d}")
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        npz_path = os.path.join(path, "arrays.npz")
        if verify and _sha256(npz_path) != manifest["sha256"]:
            raise IOError(f"checkpoint {path} corrupt (sha256 mismatch)")
        with np.load(npz_path) as data:
            if shardings is not None:
                arrays = [_place(data[k], sh) for (k, _), sh in zip(
                    _items(like_tree), _dict_leaves(shardings))]
            else:
                arrays = [torch.from_numpy(data[k]).to(
                    like.device if isinstance(like, torch.Tensor) else "cpu")
                    for k, like in _items(like_tree)]
        return _unflatten(like_tree, iter(arrays)), step
