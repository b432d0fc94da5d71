"""Boundaries of the PyTorch port: it never imports JAX or the JAX package
(checked on the source, since the test process itself has JAX loaded), its
kernels build from sources in the repo, and importing it builds nothing."""

import ast
import os
import subprocess
import sys

import pytest
import torch

from test_torch_common import REPO

pytestmark = pytest.mark.quick

PKG = os.path.join(REPO, "esrnerf_tpu_torch")


def _port_files():
    for root, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)
    yield os.path.join(REPO, "chip_smoke.py")


def _forbidden(mod: str) -> bool:
    top = mod.split(".")[0]
    return top in ("jax", "jaxlib", "esrnerf_tpu")


def test_port_never_imports_jax_or_the_reference():
    files = list(_port_files())
    assert len(files) > 15
    bad = []
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""] if node.level == 0 else []
            elif (isinstance(node, ast.Call)
                  and getattr(node.func, "id", None) == "__import__"
                  and node.args and isinstance(node.args[0], ast.Constant)):
                mods = [str(node.args[0].value)]
            else:
                continue
            bad += [f"{os.path.relpath(path, REPO)}:{node.lineno} {m}"
                    for m in mods if _forbidden(m)]
    assert not bad, bad


def test_kernel_sources_present_and_nothing_built_at_import():
    from esrnerf_tpu_torch.ops import kernels

    for src in (*kernels.SOURCES.values(), *kernels.HOST_SOURCES.values(),
                "common.cuh"):
        assert os.path.exists(os.path.join(kernels.CSRC, src)), src
    # nothing loaded by importing the port: in a fresh interpreter, since
    # an earlier test in this process may have read a PNG (which loads the
    # unfilter library)
    code = ("import importlib, pkgutil, sys; sys.path.insert(0, %r); "
            "import esrnerf_tpu_torch as p; "
            "[importlib.import_module(m.name) for m in "
            "pkgutil.walk_packages(p.__path__, 'esrnerf_tpu_torch.')]; "
            "from esrnerf_tpu_torch.ops import kernels; "
            "print(len(kernels._libs))" % REPO)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.split()[-1] == "0"


def test_cpu_tensors_take_plain_versions_and_launchers_refuse_them():
    from esrnerf_tpu_torch.ops import kernels
    from esrnerf_tpu_torch.ops import splat as splatops

    before = dict(kernels.launches)
    base = torch.tensor([0, 2, 3], dtype=torch.int32)
    vals = torch.ones((1, 1, 3))
    out = splatops.sorted_streams_splat(base, vals, (1,), 5)
    assert out[:, 0].tolist() == [0.0, 1.0, 0.0, 1.0, 1.0]
    assert kernels.launches == before  # no kernel ran
    with pytest.raises(ValueError, match="CUDA"):
        kernels.splat(base, vals, (1,), torch.zeros((5, 1)))
    with pytest.raises(ValueError, match="CUDA"):
        kernels.scan_fwd(torch.zeros((4, 3)), 1e-3)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.gather_raw(torch.zeros((5, 1)), base, (0,))


_BANNED = ("sklearn", "cv2", "PIL")


def test_port_imports_no_pil_opencv_or_sklearn():
    """No module of the port imports sklearn, OpenCV or PIL, at module level
    or inside a function, by name or through ``importlib``: the resize paths
    resample with ``data/resample.py``, so no path of the port reaches
    them."""
    bad = []
    for path in _port_files():
        rel = os.path.relpath(path, REPO)
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            mods = []
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                mods = [node.module or ""]
            elif isinstance(node, ast.Call):
                name = getattr(node.func, "id", None) or getattr(
                    node.func, "attr", None)
                if name == "import_module":
                    bad.append(f"{rel}:{node.lineno} import_module")
                elif name == "__import__" and node.args and isinstance(
                        node.args[0], ast.Constant):
                    mods = [node.args[0].value]
            bad += [f"{rel}:{node.lineno} {m}" for m in mods
                    if m.split(".")[0] in _BANNED]
    assert not bad, bad
