"""Operations and bytes of the heads and the kernels on hand-worked
shapes."""

import pytest
import torch

from benchmark.harness import flops, roofline
from benchmark.harness.launches import Recorder
from benchmark.reference.fine import eval_flops, head_dims, train_flops

CFG = {"app": {"model": {"grad_feat": [0.5, 1.0, 1.5, 2.0], "posbase_pe": 5,
                         "viewbase_pe": 1, "color_dim": 6, "rgbnet_width": 192,
                         "rgbnet_depth": 4, "tonemap_width": 192,
                         "tonemap_depth": 2, "colorbase_pe": 5}}}


def test_head_widths_and_flops():
    d = head_dims(CFG)
    # 33 position + 9 view + 6 colour + 12 normals + 24 taps + 1 sdf
    assert d["off_rgbnet"] == [85, 192, 192, 192, 3]
    assert d["tonemapper"] == [33, 192, 3]
    head = 2 * (85 * 192 + 192 * 192 + 192 * 192 + 192 * 3)
    tm = 2 * (33 * 192 + 192 * 3)
    assert flops.head_flops(d["off_rgbnet"]) == head
    n = {"head_samples": 10.0}
    assert train_flops({"cfg": CFG}, n) == 10 * 3 * (2 * head + tm)
    assert eval_flops({"cfg": CFG}, n) == 10 * (2 * head + 3 * tm)


def test_kernel_bytes_by_hand():
    assert roofline.scan_fwd(2, 3) == {"bytes": 4 * (3 * 6 + 2),
                                       "flops": 18.0}
    assert roofline.scan_bwd(2, 3)["bytes"] == 4 * (4 * 6 + 2)
    # 8 corners x 6 channels of 10 points into 7 distinct rows
    assert roofline.splat(8, 6, 10, 7) == {
        "bytes": 4 * (10 + 480 + 2 * 7 * 6), "flops": 960.0}
    assert roofline.gather_weighted(6, 8, 4096, 2048, 100)["bytes"] == \
        4 * (2048 * 9 + 600 + 4096 * 6)
    assert roofline.gather_raw(24, 10, 10, 30)["bytes"] == 4 * (10 + 30 + 240)
    assert roofline.live_rows(4096, 5, roofline.GATHER_CHUNK) == 2048
    assert roofline.live_rows(4096, 4095, roofline.GATHER_CHUNK) == 4096
    assert roofline.live_rows(4096, None) == 4096
    assert roofline.live_rows(100, 7) == 7


def test_bound_is_the_larger_of_bytes_and_operations():
    by_bytes = {"bytes": 3.35e12, "flops": 1.0}
    assert roofline.bound_s(by_bytes) == pytest.approx(1.0)
    by_ops = {"bytes": 1.0, "flops": 134e12}
    assert roofline.bound_s(by_ops) == pytest.approx(2.0)


def test_recorder_counts_distinct_rows():
    rec = Recorder()
    base = torch.tensor([0, 0, 1, 5, 9], dtype=torch.int32)
    rec.records = [
        {"kernel": "splat", "base": base, "offsets": (0, 1), "n_valid": 4,
         "S": 2, "C": 3, "M": 5, "R": 6},
        {"kernel": "gather_raw", "base": base, "offsets": (0, 2),
         "n_valid": None, "R": 10, "C": 1, "M": 5, "D": 2},
        {"kernel": "scan_fwd", "N": 4, "S": 8},
    ]
    w = rec.work()
    # splat: rows 0,1,2,5,6 of which 6 is off the table; 4 live points
    assert w[0]["bytes"] == roofline.splat(2, 3, 4, 4)["bytes"]
    # gather: rows 0,1,2,3,5,7,9 (11 off the table)
    assert w[1]["bytes"] == roofline.gather_raw(2, 5, 5, 7)["bytes"]
    assert w[2]["bound_s"] == roofline.bound_s(roofline.scan_fwd(4, 8))


def test_recorder_wraps_and_restores_the_launchers():
    from esrnerf_tpu_torch.ops import kernels

    before = {k: getattr(kernels, k) for k in roofline.KERNELS}
    with Recorder():
        assert all(getattr(kernels, k) is not before[k]
                   for k in roofline.KERNELS)
    assert all(getattr(kernels, k) is before[k] for k in roofline.KERNELS)
