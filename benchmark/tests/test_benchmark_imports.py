"""What a run loads: no module whose whole top-level name is ``jax``,
``jaxlib``, ``flax`` or ``esrnerf_tpu`` (``esrnerf_tpu_torch`` begins with
the last and is the program), and no result without a card."""

import json
import os
import shutil
import subprocess
import sys

from benchmark.harness import core

ROOT = core.ROOT


def test_forbidden_names_compare_whole_top_levels(monkeypatch):
    assert "esrnerf_tpu_torch" not in core.forbidden_modules()
    monkeypatch.setitem(sys.modules, "esrnerf_tpu_torch_extra", sys)
    assert core.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    monkeypatch.setitem(sys.modules, "esrnerf_tpu.ops", sys)
    assert core.forbidden_modules() == ["esrnerf_tpu", "jax"]


def test_a_run_loads_neither_jax_nor_the_jax_package():
    code = (
        "import sys, time, torch\n"
        f"sys.path.insert(0, {ROOT!r})\n"
        "import benchmark.controls, benchmark.run\n"
        "from benchmark.harness import core\n"
        "from benchmark.drivers import train, render\n"
        "from benchmark.tests.tiny import tiny_cell\n"
        "for k, d in (('train', train), ('render', render)):\n"
        "    d.run(core.Ctx(tiny_cell(k), 1, torch.device('cpu'), 0.0, True,\n"
        "                   time.perf_counter()))\n"
        "print(core.forbidden_modules())\n")
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, env=env, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def _run(cwd):
    return subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "fine-256.train",
         "--seed", str(2**31 + 5), "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=120, cwd=cwd,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})


def test_no_result_without_a_card():
    out = _run(ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_no_result_from_the_benchmark_alone(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    spec = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    for p in spec["paths"]:
        shutil.copytree(os.path.join(ROOT, p), tmp_path / p,
                        ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""
