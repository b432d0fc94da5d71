"""Boundaries of the PyTorch port: it never imports JAX or the JAX package
(checked on the source, since the test process itself has JAX loaded), its
kernels build from sources in the repo, and importing it builds nothing."""

import ast
import os

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
    assert not kernels._libs  # nothing loaded by importing the port


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
