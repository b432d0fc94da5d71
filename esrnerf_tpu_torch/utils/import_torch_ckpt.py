"""Import a reference (ecrireme/ESR-NeRF, PyTorch) checkpoint.

Port of ``esrnerf_tpu/utils/import_torch_ckpt.py`` (numpy, the same
tables). The reference saves ``{"renderer": {cfg, near/far, bboxes,
mask_*, s_val, num_voxels, params: state_dict}, "trainer": {global_step,
batch_st, data_idxs, optimizer}}`` (reference ``app/fine/fine.py:466-490``);
:func:`convert_checkpoint` turns it into the payload that
:mod:`esrnerf_tpu_torch.utils.checkpoint` reads (the JAX package's schema),
so a stage trained with the reference warm-starts the next stage here.

Layout conversions:
- DenseGrid ``*.grid`` ``[1, C, X, Y, Z]`` -> ``[X, Y, Z, C]``;
- ``nn.Linear`` weights ``[out, in]`` -> ``[in, out]``; sequential ReLU
  stacks (RadianceNet.linear, TonemapNet.srgb, BRDFNet.brdfnet,
  EmissionNet.brdfnet, the coarse heads' bare nn.Sequential) -> the
  ``{"w0", "b0", ...}`` MLP tree, layers in module-path order;
- SphericalGaussian ``envmap.{mus,lambdas,lobes}`` -> the same-named dict.

The optimizer state is not converted (the next stage starts its own Adam);
the sampler's position (``batch_st``, ``data_idxs``) is carried through.

:func:`load_reference` reads the checkpoint file with ``torch.load``. The
reference pickles its Hydra config inside ``renderer``; the classes of
modules that are not installed (``omegaconf`` among them) load as inert
stand-ins, since the importer reads only tensors, numbers and arrays.
"""

from __future__ import annotations

import pickle
import re
import types
from typing import Any, Dict

import numpy as np

# model kind -> {reference state_dict prefix: param key}
_GRIDS = {
    "dvgo": {"density": "density", "off_color": "off_color",
             "emo_color": "emo_color"},
    "voxurfc": {"sdf.grid": "sdf", "off_color.grid": "off_color",
                "emo_color.grid": "emo_color"},
    "voxurff": {"sdf.grid": "sdf", "off_color.grid": "off_color",
                "emo_color.grid": "emo_color"},
    "esrnerf": {"sdf.grid": "sdf", "off_color.grid": "off_color",
                "emo_color.grid": "emo_color", "brdf.grid": "brdf"},
}
_MLPS = {
    "voxurfc": {"off_rgbnet": "off_rgbnet", "emo_rgbnet": "emo_rgbnet"},
    "voxurff": {"off_rgbnet.linear": "off_rgbnet",
                "emo_rgbnet.linear": "emo_rgbnet",
                "tonemapper.srgb": "tonemapper"},
    "esrnerf": {"off_rgbnet.linear": "off_rgbnet",
                "emo_rgbnet.linear": "emo_rgbnet",
                "tonemapper.srgb": "tonemapper",
                "brdfnet.brdfnet": "brdfnet",
                "emitnet.brdfnet": "emitnet"},
}
_ENVMAP = ("mus", "lambdas", "lobes")

KINDS = ("dvgo", "voxurfc", "voxurff", "esrnerf")
# reference stage class name fragments -> model kind, most specific first
# ("fine.lts" contains "fine": a bare substring scan would import LTS and
# PDRA checkpoints as voxurff and drop brdf, emit and the envmap)
STAGE_KINDS = (
    ("fine.lts", "esrnerf"), ("fine.pdra", "esrnerf"),
    ("lts", "esrnerf"), ("pdra", "esrnerf"),
    ("alphamask", "dvgo"),
    ("coarse.coarse", "voxurfc"), ("coarse", "voxurfc"),
    ("fine", "voxurff"),
)


def infer_kind(path: str):
    """The model kind a reference checkpoint's path names (the reference
    names run directories by stage class, e.g. ``.../fine.LTS/...``), or
    None."""
    low = path.lower()
    return next((k for frag, k in STAGE_KINDS if frag in low), None)


def _np(x) -> np.ndarray:
    if hasattr(x, "detach"):  # a torch tensor
        x = x.detach().cpu().numpy()
    return np.asarray(x)


def _grid(x) -> np.ndarray:
    a = _np(x).astype(np.float32)
    if a.ndim != 5 or a.shape[0] != 1:
        raise ValueError(f"not a [1,C,X,Y,Z] grid: {a.shape}")
    return np.ascontiguousarray(np.transpose(a[0], (1, 2, 3, 0)))


def _mlp(state: Dict[str, Any], prefix: str) -> Dict[str, np.ndarray]:
    """``prefix.<seq-path>.weight/bias`` -> ``{"w0", "b0", ...}``."""
    pat = re.compile(re.escape(prefix) + r"\.((?:\d+\.)*\d+)\.(weight|bias)$")
    layers: Dict[tuple, Dict[str, np.ndarray]] = {}
    for key, val in state.items():
        m = pat.match(key)
        if m:
            path = tuple(int(p) for p in m.group(1).split("."))
            layers.setdefault(path, {})[m.group(2)] = \
                _np(val).astype(np.float32)
    if not layers:
        raise KeyError(f"no '{prefix}.*' Linear layers in state_dict")
    out: Dict[str, np.ndarray] = {}
    for i, path in enumerate(sorted(layers)):
        out[f"w{i}"] = np.ascontiguousarray(layers[path]["weight"].T)
        out[f"b{i}"] = layers[path]["bias"]
    return out


def convert_state_dict(state: Dict[str, Any], kind: str) -> Dict[str, Any]:
    """Reference ``model.state_dict()`` -> the parameter tree."""
    if kind not in KINDS:
        raise ValueError(f"unknown model kind '{kind}' (one of {KINDS})")
    params: Dict[str, Any] = {dst: _grid(state[src])
                              for src, dst in _GRIDS[kind].items()}
    for src, dst in _MLPS.get(kind, {}).items():
        params[dst] = _mlp(state, src)
    if kind == "esrnerf":
        params["envmap"] = {k: _np(state[f"envmap.{k}"]).astype(np.float32)
                            for k in _ENVMAP}
    return params


def convert_checkpoint(ref: Dict[str, Any], kind: str) -> Dict[str, Any]:
    """A whole reference checkpoint dict -> the port's payload."""
    r = ref["renderer"]
    t = ref.get("trainer", {})
    renderer: Dict[str, Any] = {
        "near": float(r["near"]),
        "far": float(r["far"]),
        "xyz_min": _np(r["xyz_min"]).astype(np.float32),
        "xyz_max": _np(r["xyz_max"]).astype(np.float32),
        "s_val": float(_np(r["s_val"])) if r.get("s_val") is not None else None,
        "num_voxels": int(r["num_voxels"]) if "num_voxels" in r else None,
        "params": convert_state_dict(r["params"], kind),
    }
    if "mask_density" in r:
        md = _np(r["mask_density"]).astype(np.float32)
        if md.ndim == 5:  # [1, 1, X, Y, Z]
            md = np.transpose(md[0], (1, 2, 3, 0))
        renderer.update(
            mask_density=md,
            mask_xyz_min=_np(r["mask_xyz_min"]).astype(np.float32),
            mask_xyz_max=_np(r["mask_xyz_max"]).astype(np.float32),
            mask_alpha_init=float(r["mask_alpha_init"]),
        )
    trainer: Dict[str, Any] = {"global_step": int(t.get("global_step", 0))}
    for k in ("batch_st", "data_idxs", "uncert_idxs", "cert_idxs",
              "uncert_batch_st", "cert_batch_st"):
        if k in t:
            trainer[k] = _np(t[k])
    return {"renderer": renderer, "trainer": trainer}


def reference_state_dict(params: Dict[str, Any], kind: str):
    """The reference's ``state_dict`` layout of a parameter tree (numpy
    arrays), which :func:`convert_state_dict` inverts: grids ``[1, C, X,
    Y, Z]``, Linear weights ``[out, in]`` at every other index of their
    ReLU stack. For writing reference-format checkpoints in tests."""
    state: Dict[str, np.ndarray] = {}
    for src, dst in _GRIDS[kind].items():
        g = np.asarray(params[dst], np.float32)
        state[src] = np.ascontiguousarray(np.transpose(g, (3, 0, 1, 2))[None])
    for src, dst in _MLPS.get(kind, {}).items():
        mlp = params[dst]
        for i in range(len(mlp) // 2):
            state[f"{src}.{2 * i}.weight"] = np.ascontiguousarray(
                np.asarray(mlp[f"w{i}"], np.float32).T)
            state[f"{src}.{2 * i}.bias"] = np.asarray(mlp[f"b{i}"],
                                                      np.float32)
    if kind == "esrnerf":
        for k in _ENVMAP:
            state[f"envmap.{k}"] = np.asarray(params["envmap"][k], np.float32)
    return state


class _StandIn:
    """An object of a class whose module is not installed: takes any
    constructor arguments and pickled state, and keeps the state (a dict
    as its attributes, anything else as ``_pickled_state``)."""

    def __new__(cls, *args, **kwargs):
        return object.__new__(cls)

    def __init__(self, *args, **kwargs):
        pass

    def __setstate__(self, state):
        if isinstance(state, dict):
            self.__dict__.update(state)
        else:
            self.__dict__["_pickled_state"] = state


class _Unpickler(pickle.Unpickler):
    def find_class(self, module, name):
        try:
            return super().find_class(module, name)
        except (ImportError, AttributeError):
            return type(name, (_StandIn,), {"__module__": module})


# ``torch.load``'s ``pickle_module``: it reads only these two names
_PICKLE = types.ModuleType("esr_reference_pickle")
_PICKLE.Unpickler = _Unpickler
_PICKLE.load = lambda f, **kw: _Unpickler(f, **kw).load()


def load_reference(path: str) -> Dict[str, Any]:
    """A reference checkpoint file, on the CPU, classes of modules that are
    not installed standing in as inert objects."""
    import torch

    return torch.load(path, map_location="cpu", weights_only=False,
                      pickle_module=_PICKLE)
