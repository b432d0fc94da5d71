"""Checkpoint save/load in the JAX package's format.

The schema is two parts, ``{"renderer": {cfg, near, far, xyz_min, xyz_max,
..., params}, "trainer": {global_step, sampler state, optimizer state}}``,
pickled (protocol 4) as host numpy arrays with grids in the ``[X,Y,Z,C]``
layout, so a stage saved by either package loads in the other. The
optimizer state is pickled under the JAX package's class name
(``esrnerf_tpu.optim.adam.AdamState``), and loading maps that name to the
port's :class:`~esrnerf_tpu_torch.optim.adam.AdamState`, so neither side
needs the other's package to read a checkpoint. Tensors leave the device
through :func:`esrnerf_tpu_torch.utils.convert.params_to_numpy` on save;
:func:`to_device` brings a loaded tree back.
"""

from __future__ import annotations

import os
import pickle
from typing import Any, Dict

import numpy as np
import torch

from esrnerf_tpu_torch.optim.adam import AdamState
from esrnerf_tpu_torch.utils.convert import params_from_jax, params_to_numpy

# the JAX package's optimizer-state class, by name only
_JAX_ADAM_STATE = ("esrnerf_tpu.optim.adam", "AdamState")


class _JaxAdamStateName:
    """Stands for the JAX optimizer-state class in a pickle stream."""


class _Pickler(pickle._Pickler):
    """Pickles the port's AdamState as the JAX package's class, written by
    name without importing that package."""

    def reducer_override(self, obj):
        if isinstance(obj, AdamState):
            return _JaxAdamStateName, tuple(obj)
        return NotImplemented

    def save_global(self, obj, name=None):
        if obj is _JaxAdamStateName:
            self.save(_JAX_ADAM_STATE[0])
            self.save(_JAX_ADAM_STATE[1])
            self.write(pickle.STACK_GLOBAL)
            self.memoize(obj)
            return
        super().save_global(obj, name)


class _Unpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if (module, name) == _JAX_ADAM_STATE:
            return AdamState
        if module.split(".")[0] == "esrnerf_tpu":
            raise pickle.UnpicklingError(
                f"checkpoint refers to {module}.{name}, which the port does "
                "not read")
        return super().find_class(module, name)


def _to_host(tree: Any) -> Any:
    """Tensors -> numpy through containers (dicts, lists, tuples and
    named tuples such as the optimizer state)."""
    if isinstance(tree, torch.Tensor):
        return params_to_numpy(tree)
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_to_host(v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_host(v) for v in tree)
    return tree


def save_checkpoint(path: str, payload: Dict[str, Any]) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        _Pickler(f, protocol=4).dump(_to_host(payload))
    os.replace(tmp, path)


def load_checkpoint(path: str) -> Dict[str, Any]:
    with open(path, "rb") as f:
        return _Unpickler(f).load()


def to_device(tree: Any, device) -> Any:
    """Numpy arrays of a loaded tree -> tensors on ``device`` (dicts and
    tuples kept; other leaves as they are)."""
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(to_device(v, device) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_device(v, device) for v in tree)
    if isinstance(tree, (np.ndarray, np.generic)):
        return params_from_jax(tree, device)
    return tree
