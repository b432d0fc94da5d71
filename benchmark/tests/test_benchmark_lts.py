"""The LTS cell at the CPU tests' size: the plain reference against the
program, a whole run, the faults and the control that ``correct`` must
catch, a traced run's per-layer metrics, and the reference's copy of the
keyed hash against the program's."""

import copy
import time

import pytest
import torch

from benchmark.drivers import train
from benchmark.harness import compare, core
from benchmark.reference import lts as ref

CPU = torch.device("cpu")
CELL = "lts-256.train"


@pytest.fixture(autouse=True)
def two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def tiny_lts_cell(heads: str = "bfloat16") -> core.Cell:
    """``lts-256.train`` cut to the CPU tests' size: 32^3 voxels, 32-wide
    heads, 256 rays a step, 16 surface points x 8 secondary rays, head
    budgets of 16 a ray (no march drops a sample at this size)."""
    cell = core.Cell.load(CELL)
    cfg = copy.deepcopy(cell.config)
    c = cfg["cfg"]
    c["app"]["trainer"].update(num_voxels=32**3, batch_size=256)
    c["app"]["model"].update(rgbnet_width=32, tonemap_width=32,
                             brdfnet_width=32, num_ltspts=16, num_2ndrays=8,
                             points_budget_per_ray=16,
                             points_budget_per_2ndray=16)
    c["system"]["compute_dtype"] = heads
    cfg["scene"]["mask_res"] = 16
    cell.config = cfg
    t = copy.deepcopy(cell.traffic)
    t.update(pool_rays=4096, trace_steps=2)
    cell.traffic = t
    return cell


def ctx_for(cell, seed=2**31 + 11, fault=None, trace=False):
    return core.Ctx(cell, seed, CPU, 0.0, trace, time.perf_counter(), fault)


def test_reference_hash_is_the_programs():
    """The reference's copy of the keyed hash against the program's, bit
    for bit: row states, lanes, uniforms and normals, for seeds and steps
    past 32 bits."""
    from esrnerf_tpu_torch.ops import keyed

    g = torch.Generator().manual_seed(0)
    ray = torch.randint(0, 2**20, (4096,), generator=g)
    sample = torch.randint(0, 4096, (4096,), generator=g)
    for seed, step in ((0, 0), (2**31 + 11, 39999), (2**40 + 3, 2**33)):
        h_p = keyed.row_hash(keyed.DrawKey(seed, step), ray, sample)
        h_r = ref.sample_hash(ref.key_state(seed, step), ray, sample)
        assert torch.equal(h_p, h_r)
        lanes_p = keyed.lanes(h_p, 40, 3)
        lanes_r = ref.lane_hash(h_r, range(3, 43))
        assert torch.equal(lanes_p, lanes_r)
        assert int(lanes_p.min()) >= 0 and int(lanes_p.max()) < 2**32
        assert torch.equal(keyed.uniform(lanes_p), ref.to_uniform(lanes_r))
        assert torch.equal(keyed.normal(lanes_p), ref.to_normal(lanes_r))


@pytest.mark.parametrize("heads,precision,tol", [
    # f32: the same arithmetic summed in other orders (the program's
    # sorted gathers and splats, the reference's dense rows)
    ("float32", "f32", 1e-4),
    # bf16 heads on both sides, their products summed in other orders: a
    # rounding moves a bf16 operand by up to one ulp (2^-8)
    ("bfloat16", "bf16", 5e-4)])
def test_reference_matches_the_program(heads, precision, tol):
    """The check steps' losses (the forward: sRGB, linear, off and emo
    MSE), the first gradient and the change of every leaf, program against
    reference."""
    ctx = ctx_for(tiny_lts_cell(heads))
    st = train.setup(ctx)
    nums = compare.train_numbers(
        st.program, train.reference_readings(ctx, st, precision))
    assert max(nums.values()) < tol, nums


def test_sound_run_is_correct():
    out = train.run(ctx_for(tiny_lts_cell()))
    assert all(c.ok for c in out["checks"]), out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0


@pytest.mark.parametrize("fault,number", [
    ("half", "loss_gap"), ("frozen", "change_gap"), ("rowdraws", "loss_gap")])
def test_faults_make_correct_false(fault, number):
    out = train.run(ctx_for(tiny_lts_cell(), fault=fault))
    failed = [c.name for c in out["checks"] if not c.ok]
    assert number in failed, out["checks"]


def test_control_fails_a_number():
    cell = tiny_lts_cell()
    ctx = ctx_for(cell)
    st = train.setup(ctx)
    nums = compare.train_numbers(train.reference_readings(ctx, st, "fp8"),
                                 train.reference_readings(ctx, st))
    limits = cell.config["limits"]["train"]
    assert any(v > limits[k] for k, v in nums.items()), nums


def test_a_traced_run_reads_every_per_layer_metric():
    """Every per-layer metric of the cell but the kernels' roofline (it
    pairs CUDA launches, none on the CPU) reads a value; every forward drew
    keyed draws (the counters count the whole process: cleared first)."""
    from esrnerf_tpu_torch.utils import profiling

    profiling.reset()
    cell = tiny_lts_cell()
    rec = train.run(ctx_for(cell, seed=5, trace=True))["run"]
    assert rec.flops and all(f > 0 for f in rec.flops)
    ms = core.read_metrics(rec, cell.per_layer)
    want = {m["name"] for m in cell.per_layer} - {"kernels.train_roofline"}
    assert want <= set(ms), sorted(want - set(ms))
    assert ms["lts.keyed_share"]["value"] == 100.0
    for name in ("lts.march_2nd_ms", "lts.segment_ms", "lts.brdf_ms",
                 "lts.draws_ms", "backward.segment_ms", "backward.brdf_ms"):
        assert ms[name]["value"] > 0, name


def test_flops_count_every_head():
    cfg = core.Cell.load(CELL).config["cfg"]
    d = ref.head_dims(cfg)
    assert d["brdfnet"] == [76, 128, 128, 128, 5]
    assert d["emitnet"] == [76, 128, 128, 128, 3]
    f = {k: float(sum(2 * a * b for a, b in zip(v, v[1:])))
         for k, v in d.items()}
    rad, brdf = f["off_rgbnet"] + f["emo_rgbnet"], f["brdfnet"] + f["emitnet"]
    n = {"head_rows": 10.0, "head_rows_2nd": 7.0, "points": 3.0}
    want = (10 * (3 * (rad + f["tonemapper"] + brdf) + brdf)
            + 3 * rad * (2 * 3 + 7))
    assert ref.train_flops({"cfg": cfg}, n) == pytest.approx(want)
