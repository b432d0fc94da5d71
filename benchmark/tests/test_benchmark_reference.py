"""The plain reference against the port at the CPU tests' size, and the
comparison that decides ``correct`` against a sound run, the control and
the faults the cells can have. The reference module itself imports nothing
of the port; this test imports both."""

import ast
import glob
import os
import time

import pytest
import torch

from benchmark.drivers import render, train
from benchmark.harness import compare, core
from benchmark.tests.tiny import tiny_cell

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def ctx_for(cell, seed=11, fault=None):
    return core.Ctx(cell, seed, CPU, 0.0, False, time.perf_counter(), fault)


def test_reference_imports_nothing_of_the_port():
    for path in glob.glob(os.path.join(core.BENCH_DIR, "reference", "*.py")):
        tree = ast.parse(open(path).read())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom)
                     else [])
            for n in names:
                assert n.split(".")[0] not in ("esrnerf_tpu_torch",
                                               *core.FORBIDDEN), (path, n)


@pytest.mark.parametrize("heads,precision,tol", [
    ("float32", "f32", 1e-4), ("bfloat16", "bf16", 1e-4)])
def test_train_steps_match_the_port(heads, precision, tol):
    ctx = ctx_for(tiny_cell("train", heads))
    st = train.setup(ctx)
    nums = compare.train_numbers(
        st.program, train.reference_readings(ctx, st, precision))
    assert max(nums.values()) < tol, nums


def test_eval_chunks_match_the_port():
    cell = tiny_cell("render", "float32")
    cell.config["limits"]["render"]["output_gap"] = 1e-5
    out = render.run(ctx_for(cell))
    assert all(c.ok for c in out["checks"]), out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0


def test_sound_bf16_run_is_correct():
    out = train.run(ctx_for(tiny_cell("train")))
    assert all(c.ok for c in out["checks"]), out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0


@pytest.mark.parametrize("kind,fault,number", [
    ("train", "half", "loss_gap"), ("train", "frozen", "change_gap"),
    ("render", "altered", "output_gap")])
def test_faults_make_correct_false(kind, fault, number):
    out = (train if kind == "train" else render).run(
        ctx_for(tiny_cell(kind), fault=fault))
    failed = [c.name for c in out["checks"] if not c.ok]
    assert number in failed, out["checks"]


def test_control_fails_a_number():
    cell = tiny_cell("train")
    ctx = ctx_for(cell)
    st = train.setup(ctx)
    nums = compare.train_numbers(train.reference_readings(ctx, st, "fp8"),
                                 train.reference_readings(ctx, st))
    limits = cell.config["limits"]["train"]
    assert any(v > limits[k] for k, v in nums.items()), nums
