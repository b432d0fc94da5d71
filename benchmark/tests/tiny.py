"""A cell cut to the CPU tests' size: 32^3 voxels, 32-wide heads, 256 rays
a step, 40x30 views. The full-size cells are for the card."""

import copy

from benchmark.harness import core


def tiny_cell(kind: str, heads: str = "bfloat16") -> core.Cell:
    cell = core.Cell.load(f"fine-256.{kind}")
    cfg = copy.deepcopy(cell.config)
    c = cfg["cfg"]
    c["app"]["trainer"].update(num_voxels=32**3, batch_size=256)
    c["app"]["model"].update(rgbnet_width=32, tonemap_width=32)
    c["app"]["eval"]["batch_size"] = 512
    c["system"]["compute_dtype"] = heads
    cfg["scene"]["mask_res"] = 16
    cell.config = cfg
    t = copy.deepcopy(cell.traffic)
    if kind == "train":
        t.update(pool_rays=4096, trace_steps=2)
    else:
        t.update(width=40, height=30, n_views=2, trace_chunks=2)
    cell.traffic = t
    return cell
