"""Shared setup of the port's parity tests -- one small fine-stage
configuration built on both sides (JAX reference and PyTorch port, the
port on the CPU), fed the same numpy inputs -- and the parity of the
port's own config loader."""

import os

import numpy as np
import pytest

pytestmark = pytest.mark.quick

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# cfg/app/fine.yaml cut to CPU size: 32^3 grids, 2-layer 32-wide heads,
# the bench's budgets (overflow 0 on the ball scene), f32 heads
OVERRIDES = [
    "app.phase=train", "data.cls=x", "data.root=x", "data.scene=x",
    "app.model.points_budget_masked_per_ray=432",
    "app.model.points_budget_per_ray=16",
    "app.model.phase1_block=8",
    "app.model.rgbnet_width=32", "app.model.rgbnet_depth=2",
    "app.model.tonemap_width=32", "app.model.tonemap_depth=2",
    "system.compute_dtype=float32", "system.mesh_axes=[]",
]
NUM_VOXELS = 32**3
N_RAYS = 64
S_VAL = 80.0


def ball_density(n=16):
    """The bench's occupancy ball as a previous-stage density grid."""
    g = np.linspace(-1, 1, n)
    xx, yy, zz = np.meshgrid(g, g, g, indexing="ij")
    r = np.sqrt(xx**2 + yy**2 + zz**2)
    return np.where(r < 0.7, 20.0, -20.0).astype(np.float32)[..., None]


def rays(n=N_RAYS, seed=0):
    """The bench's batch generator: rays from a radius-2 shell toward the
    ball, random emission modes and targets."""
    r = np.random.default_rng(seed)
    o = r.normal(size=(n, 3)).astype(np.float32)
    o = o / np.linalg.norm(o, axis=-1, keepdims=True) * 2.0
    tgt = r.normal(scale=0.3, size=(n, 3)).astype(np.float32)
    d = (tgt - o).astype(np.float32)
    vd = d / np.linalg.norm(d, axis=-1, keepdims=True)
    return {
        "rays_o": o, "rays_d": d, "viewdirs": vd.astype(np.float32),
        "em_modes": r.integers(0, 2, n).astype(np.int32),
        "rgbs": r.uniform(0, 1, (n, 3)).astype(np.float32),
    }


def load_both_cfgs(extra=()):
    from esrnerf_tpu.config import load_cfg as jload
    from esrnerf_tpu_torch.config import load_cfg as tload

    ov = OVERRIDES + list(extra)
    return (jload("cfg/app/fine.yaml", ov, root_dir=REPO),
            tload("cfg/app/fine.yaml", ov, root_dir=REPO))


def test_config_loader_matches_reference():
    jcfg, tcfg = load_both_cfgs(["app.trainer.lrs.sdf=0.25"])
    jd, td = jcfg.to_dict(), tcfg.to_dict()
    # the log name interpolates the wall clock at load time
    jd["log"].pop("name"), td["log"].pop("name")
    assert jd == td
    assert tcfg.app.trainer.lrs.sdf == 0.25
    with pytest.raises(ValueError):
        load_both_cfgs(["app.phase"])
