"""Parameter metadata machinery (the counterpart of the reference's
``models/params.py``).

Models are built once as a nested dict of :class:`ParamMeta` (shape, logical
axes, init rule). From it come random parameters (:func:`materialize`, from a
``torch.Generator``) and the parameter count; :func:`from_reference` carries
the reference's parameter tree (numpy arrays with the same nesting and keys)
across, which is how the tests hold the port to the reference.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Callable, Optional, Tuple

import numpy as np
import torch


@dataclass(frozen=True)
class ParamMeta:
    shape: Tuple[int, ...]
    logical: Tuple[Optional[str], ...]  # one logical axis name (or None) per dim
    init: str = "normal"  # normal | zeros | ones | embed | small
    fan_in: int = 0  # 0 -> product of all dims except last
    dtype: str = "float32"

    def __post_init__(self):
        assert len(self.shape) == len(self.logical), (self.shape, self.logical)


def tree_map(fn: Callable[[Any], Any], tree):
    """Apply ``fn`` to every leaf of a nested dict (keys in sorted order)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k]) for k in sorted(tree)}
    return fn(tree)


def tree_leaves(tree) -> list:
    out = []
    tree_map(out.append, tree)
    return out


def n_params(tree) -> int:
    return sum(int(np.prod(m.shape)) for m in tree_leaves(tree))


def torch_dtype(name) -> torch.dtype:
    """A dtype name of the configs ("bfloat16", "float32", ...) as torch's."""
    return name if isinstance(name, torch.dtype) else getattr(torch, name)


def materialize(tree, generator: torch.Generator,
                dtype: Optional[str] = None, device=None):
    """Random parameters for a ParamMeta tree, with the reference's init
    rules: ``normal``/``embed`` draw N(0, 1) / sqrt(fan_in), ``small`` 0.1 of
    that, ``ones`` and ``zeros`` are constant. The draws come from
    ``generator`` (on ``device``), leaf by leaf in sorted key order."""

    def make(m: ParamMeta):
        dt = torch_dtype(dtype or m.dtype)
        if m.init == "zeros":
            return torch.zeros(m.shape, dtype=dt, device=device)
        if m.init == "ones":
            return torch.ones(m.shape, dtype=dt, device=device)
        fan_in = m.fan_in or (int(np.prod(m.shape[:-1])) or 1)
        scale = {"normal": 1.0, "embed": 1.0, "small": 0.1}[m.init] \
            / np.sqrt(fan_in)
        x = torch.randn(m.shape, generator=generator, dtype=torch.float32,
                        device=device)
        return x.mul_(float(scale)).to(dt)  # in place: one float32 copy

    return tree_map(make, tree)


def from_reference(tree, device=None):
    """The reference's parameter tree (numpy arrays, or anything
    ``np.asarray`` takes, under the same keys) as torch tensors of the same
    dtypes; stacked ``(L, ...)`` leaves stay stacked."""
    def conv(a):
        a = np.array(a)
        if a.dtype.name == "bfloat16":  # ml_dtypes' bfloat16: via float32
            return torch.from_numpy(a.astype(np.float32)).to(
                device=device, dtype=torch.bfloat16)
        return torch.from_numpy(a).to(device)

    return tree_map(conv, tree)


# --- small helpers used by the model definitions ---------------------------

def dense(d_in: int, d_out: int, l_in=None, l_out=None, **kw) -> ParamMeta:
    return ParamMeta((d_in, d_out), (l_in, l_out), fan_in=d_in, **kw)


def stack(meta: ParamMeta, n: int, axis_name: str = "layers") -> ParamMeta:
    """Add a leading stacked-layers dim."""
    return dataclasses.replace(
        meta, shape=(n,) + meta.shape, logical=(axis_name,) + meta.logical)


def stack_tree(tree, n: int):
    return tree_map(lambda m: stack(m, n), tree)
