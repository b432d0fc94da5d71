"""The port's DTU scene family against the JAX package, on the CPU: the
camera decomposition (against OpenCV too), the loader's arrays on a
JAX-written (PIL) and a port-written scene, the DTU-format writer's files,
the PLY reader, the Chamfer-distance eval (against the JAX package's
sklearn version), and alphamask -> coarse -> fine -> LTS through
``esrnerf_tpu_torch.run.main`` on a DTU-format scene.

Tolerances: images, masks, light modes, the Chamfer assets, the writer's
files and the Chamfer downsampling mask are bitwise. The two camera
decompositions (OpenCV's Givens rotations, scipy's Householder RQ) round
differently, so K and the camera agree to 1e-9 of the matrix's largest
entry in float64, and the float32 pose to one float32 ulp of its block's
scale (1 for the rotation, the largest centre coordinate for the
centre); rays to one float32 ulp of each ray's largest component; far
(from the float32 camera centres) to one float32 ulp (near is 0.05 far
on both sides), the focal length to 1e-12 relative. The Chamfer means agree to 1e-12 relative."""

import json
import os
import subprocess
import sys

import cv2
import numpy as np
import pytest
import torch
from PIL import Image
from scipy.io import loadmat
from scipy.ndimage import maximum_filter

from esrnerf_tpu.config import load_cfg as jload
from esrnerf_tpu.data import dtu as jdtu
from esrnerf_tpu.data.synthetic import write_dtu_scene as jwrite
from esrnerf_tpu.utils import mesh as jmesh
from esrnerf_tpu.utils import metrics as jmetrics
from esrnerf_tpu_torch import run as trun
from esrnerf_tpu_torch.config import load_cfg as tload
from esrnerf_tpu_torch.data import dtu as tdtu
from esrnerf_tpu_torch.data.synthetic import write_dtu_scene as twrite
from esrnerf_tpu_torch.utils import mesh as tmesh
from esrnerf_tpu_torch.utils import metrics as tmetrics

from test_torch_common import REPO

pytestmark = pytest.mark.quick

N_VIEWS, WH = 8, 40


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    """A DTU-format scene written by each package (scan 97)."""
    root = str(tmp_path_factory.mktemp("dtu"))
    jwrite(f"{root}/jax", scan=97, n_views=N_VIEWS, wh=WH)
    twrite(f"{root}/port", scan=97, n_views=N_VIEWS, wh=WH)
    return root


def _cfgs(root):
    ov = ["app.phase=train", f"data.root={root}"]
    cfg = os.path.join(REPO, "cfg/exp/dtu/97/coarse.yaml")
    return jload(cfg, ov, root_dir=REPO), tload(cfg, ov, root_dir=REPO)


# ------------------------------------------------------------- the cameras


def _random_cameras(rng):
    """Projection matrices: a skewed K, one with det(M) < 0, a camera
    behind the origin (looking away from it), and random ones."""
    def rot(rng):
        q, r = np.linalg.qr(rng.normal(size=(3, 3)))
        q = q * np.sign(np.diag(r))
        return q if np.linalg.det(q) > 0 else -q

    out = []
    for k in range(12):
        K = np.array([[rng.uniform(30, 3000), rng.uniform(-5, 5),
                       rng.uniform(10, 800)],
                      [0, rng.uniform(30, 3000), rng.uniform(10, 600)],
                      [0, 0, 1.0]])
        if k == 0:
            K[0, 1] = 0.3 * K[0, 0]  # strongly skewed
        R, c = rot(rng), rng.normal(size=3) * 3
        if k == 2:
            c = -2.5 * R[2]  # the origin behind the camera
        P = K @ np.hstack([R, -R @ c[:, None]])
        if k == 1 or k % 4 == 3:
            P = -P  # det(M) < 0: OpenCV returns K[2, 2] < 0
        out.append(P)
    return out


def _writer_cameras(roots):
    d = np.load(f"{roots}/jax/dtu_scan97/cameras_sphere.npz")
    return [(d[f"world_mat_{i}"] @ d[f"scale_mat_{i}"])[:3, :4]
            for i in range(N_VIEWS)]


def _pose_close(got, want):
    """float32 poses within one float32 ulp of each block's scale."""
    np.testing.assert_allclose(got[:3, :3], want[:3, :3], rtol=0,
                               atol=np.spacing(np.float32(1)))
    c = np.abs(want[:3, 3]).max()
    np.testing.assert_allclose(got[:3, 3], want[:3, 3], rtol=0,
                               atol=np.spacing(np.float32(c)))
    np.testing.assert_array_equal(got[3], want[3])


def test_load_K_Rt_from_P_matches_opencv_and_jax(roots):
    Ps = _writer_cameras(roots) + _random_cameras(np.random.default_rng(0))
    neg = 0
    for P in Ps:
        K, pose = tdtu.load_K_Rt_from_P(P)
        # OpenCV in float64, then the IDR normalisation and pose
        Kc, Rc, tc = cv2.decomposeProjectionMatrix(P.astype(np.float64))[:3]
        neg += Kc[2, 2] < 0
        Kc = Kc / Kc[2, 2]
        np.testing.assert_allclose(K[:3, :3], Kc, rtol=0,
                                   atol=1e-9 * np.abs(Kc).max())
        assert np.linalg.det(Rc) > 0 and np.sign(K[0, 0]) == np.sign(Kc[0, 0])
        c = -np.linalg.solve(P[:, :3], P[:, 3])
        cc = (tc[:3] / tc[3])[:, 0]
        np.testing.assert_allclose(c, cc, rtol=0,
                                   atol=1e-9 * np.abs(cc).max())
        pc = np.eye(4, dtype=np.float32)
        pc[:3, :3], pc[:3, 3] = Rc.T, cc
        _pose_close(pose, pc)
        # the JAX package's function, on P and on float32 P (the loader's)
        for p in (P, P.astype(np.float32)):
            Kj, pj = jdtu.load_K_Rt_from_P(p)
            Kt, pt = tdtu.load_K_Rt_from_P(p)
            np.testing.assert_allclose(Kt, Kj, rtol=0,
                                       atol=1e-9 * np.abs(Kj).max())
            assert pt.dtype == pj.dtype == np.float32
            _pose_close(pt, pj)
    assert neg >= 3  # the det(M) < 0 cases: OpenCV's K[2, 2] < 0


# ------------------------------------------------------------ the loader


def _ulps(a, b):
    """|a - b| in float32 ulps of each row's largest magnitude."""
    m = np.maximum(np.abs(a), np.abs(b)).max(-1, keepdims=True)
    return float((np.abs(a.astype(np.float64) - b)
                  / np.spacing(m.astype(np.float32))).max())


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("phase", ["train", "test_nv"])
def test_dtu_arrays_match_jax(roots, writer, phase):
    jc, tc = _cfgs(f"{roots}/{writer}")
    j, t = jdtu.DTU(jc, phase), tdtu.DTU(tc, phase)
    assert set(t.all_data) == set(j.all_data)
    for k, want in j.all_data.items():
        got = t.all_data[k]
        assert got.dtype == want.dtype and got.shape == want.shape, k
        if k in ("rgbs", "hdrs", "em_modes"):
            np.testing.assert_array_equal(got, want, err_msg=k)
        elif k == "poses":
            for a, b in zip(got, want):
                _pose_close(a, b)
        else:
            assert _ulps(got, want) <= 1.0, k
    if phase == "test_nv":
        assert t.all_data["hdrs"] is t.all_data["rgbs"]
        assert t.all_data["em_modes"].shape == (N_VIEWS, 1)
    (tn, tf), (jn, jf) = t.near_far, j.near_far  # far: max |c_i - c_j|
    assert abs(tf - jf) <= np.spacing(np.float32(jf))
    assert tn == 0.05 * tf and jn == 0.05 * jf
    assert abs(t.focal_length - j.focal_length) <= 1e-12 * j.focal_length
    assert t.image_size == j.image_size == (WH, WH)
    np.testing.assert_array_equal(t.scale_mat, j.scale_mat)
    assert len(t.pcd) == len(j.pcd) == 5
    for a, b in zip(t.pcd, j.pcd):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert len(t) == len(j)


def test_dtu_without_chamfer_assets(tmp_path):
    twrite(str(tmp_path), scan=97, n_views=3, wh=16, chamfer_assets=False)
    _, tc = _cfgs(str(tmp_path))
    assert tdtu.DTU(tc, "test_nv").pcd is None


def test_imresize_at_the_same_size_is_the_identity():
    """The JAX loader resizes to the image's own size through uint8 (PIL);
    every level survives, so the port returns its input unchanged."""
    levels = np.arange(256, dtype=np.float32) / 255.0
    img = np.stack([np.tile(levels, (3, 1))] * 3, -1)  # [3, 256, 3]
    got = tdtu._imresize(img, (256, 3))
    assert got is img
    np.testing.assert_array_equal(got, jdtu._imresize(img, (256, 3)))


def test_loader_imports_no_pil_opencv_or_sklearn(roots):
    """At ``resize: 1.0`` the loader and the Chamfer eval need none of
    PIL, OpenCV and sklearn (a fresh interpreter)."""
    code = f"""
import sys
sys.path.insert(0, {REPO!r})
from esrnerf_tpu_torch.config import load_cfg
from esrnerf_tpu_torch.data.dtu import DTU
from esrnerf_tpu_torch.utils.metrics import DTU_CD
cfg = load_cfg({REPO!r} + "/cfg/exp/dtu/97/coarse.yaml",
               ["app.phase=train", "data.root={roots}/jax"], root_dir={REPO!r})
ds = DTU(cfg, "train")
stl = ds.pcd[3]
print(DTU_CD(stl, __import__("numpy").zeros((0, 3), int), *ds.pcd))
bad = [m for m in ("PIL", "cv2", "sklearn") if m in sys.modules]
assert not bad, bad
"""
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]


# ------------------------------------------------------------ the writer


def test_writer_files_match_jax(roots):
    j, t = f"{roots}/jax", f"{roots}/port"
    for sub in ("image", "mask"):
        names = sorted(os.listdir(f"{j}/dtu_scan97/{sub}"))
        assert names == sorted(os.listdir(f"{t}/dtu_scan97/{sub}"))
        assert len(names) == N_VIEWS
        for n in names:
            np.testing.assert_array_equal(
                np.asarray(Image.open(f"{t}/dtu_scan97/{sub}/{n}")),
                np.asarray(Image.open(f"{j}/dtu_scan97/{sub}/{n}")))
    cj = np.load(f"{j}/dtu_scan97/cameras_sphere.npz")
    ct = np.load(f"{t}/dtu_scan97/cameras_sphere.npz")
    assert sorted(cj.files) == sorted(ct.files)
    for k in cj.files:
        assert ct[k].dtype == cj[k].dtype
        np.testing.assert_array_equal(ct[k], cj[k])
    for name, keys in (("ObsMask97_10", ("ObsMask", "BB", "Res")),
                       ("Plane97", ("P",))):
        mj, mt = loadmat(f"{j}/ObsMask/{name}.mat"), \
            loadmat(f"{t}/ObsMask/{name}.mat")
        for k in keys:
            assert mt[k].dtype == mj[k].dtype
            np.testing.assert_array_equal(mt[k], mj[k])
    ply = "Points/stl/stl097_total.ply"
    pj, pt = jmesh.load_ply(f"{j}/{ply}")[0], jmesh.load_ply(f"{t}/{ply}")[0]
    assert pt.shape == (8000, 3)
    np.testing.assert_array_equal(pt, pj)


def test_load_ply_matches_jax(tmp_path):
    rng = np.random.default_rng(0)
    v = rng.normal(size=(37, 3)).astype(np.float32)
    # binary: the port's writer (vertices and faces)
    path = str(tmp_path / "b.ply")
    tmesh.export_ply(path, v, rng.integers(0, 37, (5, 3)))
    # binary with more vertex properties, doubles
    rec = np.zeros(37, [("nx", "<f4"), ("x", "<f8"), ("y", "<f8"),
                        ("z", "<f8"), ("red", "u1")])
    rec["x"], rec["y"], rec["z"] = v[:, 0], v[:, 1], v[:, 2]
    rec["nx"], rec["red"] = 1.5, 7
    path2 = str(tmp_path / "d.ply")
    with open(path2, "wb") as f:
        f.write(b"ply\nformat binary_little_endian 1.0\nelement vertex 37\n"
                b"property float nx\nproperty double x\nproperty double y\n"
                b"property double z\nproperty uchar red\nend_header\n"
                + rec.tobytes())
    # ascii, with a colour and a face element after the vertices
    path3 = str(tmp_path / "a.ply")
    with open(path3, "w") as f:
        f.write("ply\nformat ascii 1.0\nelement vertex 37\nproperty float x\n"
                "property float y\nproperty float z\nproperty uchar red\n"
                "element face 1\nproperty list uchar int vertex_indices\n"
                "end_header\n")
        for p in v:
            f.write(" ".join(repr(float(x)) for x in p) + " 200\n")
        f.write("3 0 1 2\n")
    for p in (path, path2, path3):
        got, faces = tmesh.load_ply(p)
        want, wfaces = jmesh.load_ply(p)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, v)
        assert faces.shape == wfaces.shape == (0, 3)


# ------------------------------------------------------- the Chamfer eval


def _sklearn_mask(pts, thresh):
    """The JAX package's downsampling loop (every ball up front)."""
    import sklearn.neighbors as skln

    nn = skln.NearestNeighbors(n_neighbors=1, radius=thresh,
                               algorithm="kd_tree", n_jobs=-1).fit(pts)
    idxs = nn.radius_neighbors(pts, radius=thresh, return_distance=False)
    mask = np.ones(len(pts), bool)
    for curr, ii in enumerate(idxs):
        if mask[curr]:
            mask[ii] = 0
            mask[curr] = 1
    return mask


def _two_balls_mesh(n=40):
    from esrnerf_tpu_torch.data.synthetic import (DIFF_CENTER, DIFF_R,
                                                  EMIT_CENTER, EMIT_R)

    g = np.linspace(-1, 1, n)
    p = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1)
    f = np.maximum(EMIT_R - np.linalg.norm(p - EMIT_CENTER, axis=-1),
                   DIFF_R - np.linalg.norm(p - DIFF_CENTER, axis=-1))
    v, t = tmesh.marching_cubes(f.astype(np.float32), 0.0)
    return v * (2.0 / (n - 1)) - 1.0, t


@pytest.mark.parametrize("thresh", [0.2, 0.03])
def test_dtu_cd_matches_jax(roots, thresh):
    """Meshes of the two-ball SDF against the written assets: at 0.2 each
    ball holds about a twentieth of the points (the balls overlap heavily);
    at 0.03 about ten points."""
    v, t = _two_balls_mesh()
    _, tc = _cfgs(f"{roots}/port")
    pcd = tdtu.DTU(tc, "test_nv").pcd
    got = tmetrics.DTU_CD(v, t, *pcd, thresh=thresh)
    want = jmetrics.DTU_CD(v, t, *pcd, thresh=thresh)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)
    assert all(np.isfinite(got))
    # the downsampling mask on the protocol's input (vertices, shuffled)
    pts = v.astype(np.float64)
    np.random.default_rng(0).shuffle(pts, axis=0)
    mask = tmetrics.radius_downsample_mask(pts, thresh)
    np.testing.assert_array_equal(mask, _sklearn_mask(pts, thresh))
    assert 0 < mask.sum() < len(pts)


def test_downsample_mask_includes_points_at_exactly_thresh():
    thresh = 0.2
    rng = np.random.default_rng(1)
    pts = np.concatenate([
        [[0.0, 0.0, 0.0], [thresh, 0.0, 0.0], [0.0, -thresh, 0.0],
         [0.0, 0.0, np.nextafter(thresh, 1.0)]],
        rng.uniform(-1, 1, (300, 3))])
    mask = tmetrics.radius_downsample_mask(pts, thresh)
    np.testing.assert_array_equal(mask, _sklearn_mask(pts, thresh))
    # both at exactly thresh from the first point drop, the one past it not
    assert mask[0] and not mask[1] and not mask[2] and mask[3]


# --------------------------------------------- the chain through run.main

MICRO = {
    "alphamask": ["app.model.num_voxels=8000", "app.trainer.batch_size=256"],
    "coarse": ["app.model.num_voxels=16384", "app.trainer.batch_size=128",
               "app.model.rgbnet_width=32"],
    "fine": ["app.trainer.num_voxels=4096", "app.trainer.batch_size=64",
             "app.trainer.s_start=40", "app.trainer.pg_scale=[]",
             "app.model.rgbnet_width=32", "app.model.rgbnet_depth=2",
             "app.model.tonemap_width=32", "app.model.tonemap_depth=2",
             "app.model.points_budget_masked_per_ray=432",
             "app.model.points_budget_per_ray=16"],
}
MICRO["lts"] = MICRO["fine"][1:4] + MICRO["fine"][4:] + [
    "app.model.brdfnet_width=32", "app.model.brdfnet_depth=2",
    "app.model.num_ltspts=16", "app.model.num_2ndrays=4",
    "app.model.points_budget_masked_per_2ndray=128",
    "app.model.points_budget_per_2ndray=16"]
ITERS = {"alphamask": 120, "coarse": 60, "fine": 8, "lts": 4}


@pytest.fixture(scope="module")
def dtu_chain(tmp_path_factory):
    """The four DTU stages through the port's entry point on a port-written
    scene, each finding the previous stage's ``last.ckpt`` by path (one
    ``log.root`` and ``log.name``), each ending with its test_nv eval:
    ``(root, {stage: (log dir, metric rows)})``."""
    root = str(tmp_path_factory.mktemp("dtu_chain"))
    twrite(f"{root}/data", scan=97, n_views=N_VIEWS, wh=WH)
    runs = {}
    # one intra-op thread: as fast at these shapes, and the many small ops
    # of alphamask's steps do not wait on threads that other test
    # processes keep busy
    n_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for stage, n in ITERS.items():
            runs[stage] = _run_stage(root, stage, n)
    finally:
        torch.set_num_threads(n_threads)
    return root, runs


def _run_stage(root, stage, n):
    """One stage through ``run.main``: ``(log dir, metric rows)``; its
    second step traced into ``<root>/prof/<stage>`` (``system.profile_*``)."""
    app = trun.main([
        "-cn", os.path.join(REPO, f"cfg/exp/dtu/97/{stage}.yaml"),
        "app.phase=train", f"data.root={root}/data",
        f"log.root={root}/logs", "log.name=t", "log.offline=true",
        "system.debug=true", "system.compute_dtype=float32",
        "system.tqdm_iters=1", "system.device=cpu",
        "app.eval.batch_size=400", "app.trainer.N_vis=1",
        f"app.trainer.n_iters={n}", f"app.trainer.vis_every={n}",
        f"app.trainer.save_every={n}", f"system.profile_dir={root}/prof/"
        f"{stage}", "system.profile_from=1", "system.profile_steps=1",
        *MICRO[stage]])
    assert app.global_step == n - 1
    with open(os.path.join(app.cfg.log["dir"], "metrics.jsonl")) as f:
        return app.cfg.log["dir"], [json.loads(ln) for ln in f]


def test_run_main_chains_dtu_alphamask_to_lts_on_cpu(dtu_chain):
    """Coarse, fine and LTS log a finite ``mesh/CD``, fine and LTS the
    off-light HDR error (DTU's test HDRs are its images); every march keeps
    samples on every step without overflow (an empty march has no overflow
    either), the LTS secondary march too. Each stage's loop traced its
    second step (the fine backward split by phase) and logged its spans'
    host ms."""
    root, runs = dtu_chain
    evals = {}
    for stage, n in ITERS.items():
        log_dir, rows = runs[stage]
        assert all(np.isfinite(v) for r in rows for v in r.values())
        train = [r for r in rows if "train/metric/srgb/MSE" in r]
        assert [r["step"] for r in train] == list(range(n))
        for k in (f"{stage}/loss", f"{stage}/backward", "data/sample",
                  "data/place"):
            assert all(r[f"train/metric/etc/host_ms/{k}"] > 0
                       for r in train), (stage, k)
        with open(f"{root}/prof/{stage}/trace_1.json") as f:
            names = {e.get("name") for e in json.load(f)["traceEvents"]}
        assert {f"{stage}/loss", f"{stage}/backward", "data/sample"} <= names
        bwd = {f"fine/bwd_{p}" for p in ("loss", "heads", "features",
                                         "march")}
        assert (bwd <= names) == (stage == "fine"), stage
        if stage != "alphamask":
            assert all(r["train/metric/etc/overflow"] == 0.0 for r in train)
            fracs = ["k1_frac", "k2_frac"] + (
                ["k1_frac_2nd", "k2_frac_2nd"] if stage == "lts" else [])
            for k in fracs:
                low = min(r[f"train/metric/etc/{k}"] for r in train)
                assert low > 0, (stage, k)
        (ev,) = [r for r in rows if "test_nv/metric/srgb/PSNR" in r]
        evals[stage] = ev
        assert os.path.exists(os.path.join(log_dir, "checkpoints",
                                           "last.ckpt"))
    for stage in ("coarse", "fine", "lts"):
        cd = evals[stage]["test_nv/metric/mesh/CD"]
        assert np.isfinite(cd) and 0 < cd < 1.0, (stage, cd)
        assert evals[stage]["test_nv/metric/etc/cd_s"] > 0
    assert "test_nv/metric/mesh/CD" not in evals["alphamask"]
    for stage in ("fine", "lts"):
        assert np.isfinite(evals[stage]["test_nv/metric/lin/MSE_EXR_off"])
        assert "test_nv/metric/lin/MSE_EXR_on" not in evals[stage]


def test_lts_step_on_the_dtu_fine_checkpoint_matches_jax(dtu_chain):
    """One LTS step from the chain's DTU fine checkpoint (its boxes, mask
    cache and SDF; the other groups from one JAX init) on 64 of its kept
    rays, against the JAX package's LTS step on the same inputs and draws,
    at the synthetic LTS step's tolerances, on rays that enter the box off
    the surface band (see below). The fine stage's box is the
    coarse stage's, inside the alphamask box of the mask cache, so the
    reference's ``occ64`` (resampled on the mask's box) is not the
    partition its band cull taps: the JAX model is given the port's
    (``resample_occ64``, on the model's box), which keeps samples the
    reference's overlay drops."""
    from esrnerf_tpu.models import voxurf_base as jvb
    from esrnerf_tpu.models.esrnerf import ESRNeRF as JESRNeRF
    from esrnerf_tpu_torch.models import voxurf_base as tvb
    from esrnerf_tpu_torch.models.esrnerf import ESRNeRF as TESRNeRF
    from esrnerf_tpu_torch.utils import checkpoint as ckpt_io
    from test_torch_lts_step import (assert_lts_step_close, jax_draws,
                                     jax_lts_grads, port_lts_grads)

    import jax
    import jax.numpy as jnp

    root, runs = dtu_chain
    fine_dir, _ = runs["fine"]
    payload = ckpt_io.load_checkpoint(
        os.path.join(fine_dir, "checkpoints", "last.ckpt"))
    r = payload["renderer"]
    ov = ["app.phase=train", f"data.root={root}/data",
          "system.compute_dtype=float32", "system.mesh_axes=[]",
          *MICRO["lts"]]
    cfg = os.path.join(REPO, "cfg/exp/dtu/97/lts.yaml")
    jcfg, tcfg = jload(cfg, ov, root_dir=REPO), tload(cfg, ov, root_dir=REPO)
    m = tcfg.app.model
    mc_args = (np.asarray(r["mask_density"]), np.asarray(r["mask_xyz_min"]),
               np.asarray(r["mask_xyz_max"]), r["mask_alpha_init"],
               m["maskcache_thres"], m["mask_ks"])
    box = (r["near"], r["far"], np.asarray(r["xyz_min"]),
           np.asarray(r["xyz_max"]))
    s_val = float(tcfg.app.trainer["s_start"])
    tm = TESRNeRF(tcfg, *box, tvb.make_mask_cache(*mc_args, device="cpu"),
                  s_val, r["num_voxels"])
    jmc = jvb.make_mask_cache(*mc_args)
    assert not np.array_equal(tm.geo.occ64.numpy(), np.asarray(jmc.occ64))
    jm = JESRNeRF(jcfg, *box,
                  jmc._replace(occ64=jnp.asarray(tm.geo.occ64.numpy())),
                  s_val, r["num_voxels"])

    params = jax.tree.map(np.asarray, jm.init_params(jax.random.PRNGKey(0)))
    for k in params:
        if k in r["params"]:
            params[k] = jax.tree.map(np.asarray, r["params"][k])
    # 64 kept rays whose entry into the box lies off the surface band: a
    # ray's first sample lies on a box face, where an ulp decides whether
    # it is inside, and the DTU box (the coarse stage's) hugs the surface.
    # XLA contracts the sampler's multiply-adds into FMAs under jit, so
    # there JAX's jitted step and its own eager forward keep different
    # first samples, while the port keeps the eager forward's.
    data = tdtu.DTU(tcfg, "train").all_data
    cand = np.asarray(payload["trainer"]["data_idxs"])[:2048]
    ro, rd = data["rays_o"][cand], data["rays_d"][cand]
    with np.errstate(divide="ignore"):
        t_lo, t_hi = (box[2] - ro) / rd, (box[3] - ro) / rd
    entry = ro + rd * np.minimum(t_lo, t_hi).max(-1, keepdims=True)
    band = maximum_filter(np.asarray(jm.geo.band_occ64(
        jnp.asarray(params["sdf"]), jnp.float32(s_val))), 3)
    at_band = np.asarray(jm.geo.query_nearest64(
        jnp.asarray(band), jnp.asarray(entry, jnp.float32)))
    idx = cand[~at_band][:64]
    assert len(idx) == 64
    b = {k: data[k][idx] for k in ("rgbs", "rays_o", "rays_d", "viewdirs",
                                   "em_modes")}
    b["uncert_masks"] = np.ones(len(idx), bool)

    key = jax.random.PRNGKey(5)
    args = (s_val, 1.0, 0.05, 0.01 * 0.1 / 64, True)
    g_j, aux_j = jax_lts_grads(jcfg, jm, params, b, args, key)
    g_t, aux_t = port_lts_grads(tcfg, tm, params, b, args,
                                jax_draws(jm, key, len(idx)))
    assert min(aux_t[5:9]) > 0  # k1, k2, k1_2nd, k2_2nd: the marches keep
    assert_lts_step_close(g_j, aux_j, g_t, aux_t)


@pytest.mark.parametrize("window,budget", [(7, 50), (64, 1), (1 << 16, 1)])
@pytest.mark.parametrize("scale", ["unit", "mm"])
def test_downsample_mask_batches_match_sklearn(window, budget, scale):
    """The batched walk at small windows and budgets (empty windows, one
    ball a batch, batches whose earlier balls drop later points) on a
    unit-scale cloud (balls of a few percent of the points) and on a
    millimetre-scale one (balls of a few points, as on a real scan): the
    sklearn loop's mask bit for bit."""
    rng = np.random.default_rng(7)
    if scale == "unit":
        pts, thresh = rng.uniform(-1, 1, (3000, 3)), 0.2
    else:
        uv = rng.uniform(0, 12, (3000, 2))
        pts = np.concatenate([uv, 0.05 * np.sin(uv[:, :1])], 1)
        thresh = 0.2
    mask = tmetrics.radius_downsample_mask(pts, thresh, window=window,
                                           budget=budget)
    np.testing.assert_array_equal(mask, _sklearn_mask(pts, thresh))
    assert 0 < mask.sum() < len(pts)
