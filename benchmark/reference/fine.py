"""Plain PyTorch reference of the fine stage (VoxurfF) for the benchmark.

It follows the fine stage's published description (ESR-NeRF, Voxurf) as the
configuration file states it, in float32 with TF32 off, and imports nothing
of the program under test:

- the previous stage's occupancy mask: a density grid max-pooled by
  ``mask_ks`` and tested in alpha space (``alpha >= maskcache_thres``);
- the march: every ray sampled densely at ``stepsize`` voxels from its
  box entry, the samples inside the mask kept, their SDF sampled
  trilinearly, the interp-variant NeuS alpha from the midpoints with the
  previous and next kept sample of the ray, an ``alpha > fastcolor_thres``
  pre-filter, the transmittance scan with its early exit at T < 1e-3, and
  the samples with ``weight > fastcolor_thres`` sent to the heads. No
  sample budget: the program's static budgets must drop nothing;
- the features (normalised position and its sin/cos encoding, the view
  direction's, the SDF value, 6-neighbour SDF taps at the ``grad_feat``
  displacements and their normals), the off / emission colour grids, the
  two radiance heads, the tone-mapper, and the per-ray weighted sums;
- the loss (sRGB MSE, linear MSE through the gamma curve, the last ray's
  entropy, the smooth-gradient TV every ``tv_every`` steps), the SDF TV as
  a gradient term, and per-group Adam with the cosine schedule;
- the eval forward of one chunk (off, on and emission radiance, normals,
  depth, disparity).

``precision="fp8"`` rounds every head operand, forward and backward, to
float8 e4m3 with a per-tensor scale: the control that a lower precision than
the configuration's bfloat16 heads must fail.

The inputs (the mask density, the weights, the rays) are made here or by the
benchmark's traffic generator from the seed, and handed to the program and to
this reference alike.

The harness finds this module by the configuration's ``stage`` and calls
``make_weights``, ``train_steps``, ``eval_chunks``, ``leaves`` and the
stage's operation counts ``train_flops`` and ``eval_flops``.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import numpy as np
import torch

from benchmark.harness.flops import head_flops

EARLY_EXIT_T = 1e-3
FP8_MAX = 448.0  # largest finite float8 e4m3 value


# ---------------------------------------------------------------- geometry


class Geometry:
    """The scene box, the voxel grid of ``num_voxels`` and the occupancy
    mask of the previous stage, on ``device``."""

    def __init__(self, cfg: dict, scene: dict, device):
        m = cfg["app"]["model"]
        self.device = torch.device(device)
        self.xyz_min = np.asarray(scene["xyz_min"], np.float32)
        self.xyz_max = np.asarray(scene["xyz_max"], np.float32)
        self.near, self.far = float(scene["near"]), float(scene["far"])
        self.num_voxels = int(cfg["app"]["trainer"]["num_voxels"])
        extent = self.xyz_max - self.xyz_min
        self.voxel_size = float((extent.prod() / self.num_voxels) ** (1 / 3))
        self.world_size = tuple(int(x) for x in
                                (extent / self.voxel_size).astype(np.int64))
        self.stepsize = float(m["stepsize"])
        self.n_samples = int(float(np.linalg.norm(
            np.asarray(self.world_size) + 1)) / self.stepsize) + 1
        self.stepdist = self.stepsize * self.voxel_size
        self.lo = torch.tensor(self.xyz_min, device=self.device)
        self.hi = torch.tensor(self.xyz_max, device=self.device)
        # the occupancy mask: max-pooled density, thresholded in alpha
        dens = torch.as_tensor(mask_density(scene), device=self.device)
        ks = int(m["mask_ks"])
        self.mask = torch.nn.functional.max_pool3d(
            dens[None, None], ks, stride=1, padding=ks // 2)[0, 0]
        self.mask_lo = torch.tensor(scene["mask_xyz_min"], dtype=torch.float32,
                                    device=self.device)
        self.mask_hi = torch.tensor(scene["mask_xyz_max"], dtype=torch.float32,
                                    device=self.device)
        a0 = float(scene["mask_alpha_init"])
        self.act_shift = math.log(1.0 / (1.0 - a0) - 1.0)
        self.mask_thres = float(m["maskcache_thres"])

    def index(self, xyz, size, lo=None, hi=None):
        """World points -> fractional grid indices (corners aligned)."""
        lo = self.lo if lo is None else lo
        hi = self.hi if hi is None else hi
        sz = torch.tensor([float(s) for s in size], device=xyz.device)
        return (xyz - lo) / (hi - lo) * (sz - 1.0)

    @torch.no_grad()
    def in_mask(self, xyz):
        """The previous stage's occupancy test at world points ``[..., 3]``."""
        shape = xyz.shape[:-1]
        idx = self.index(xyz.reshape(-1, 3), self.mask.shape, self.mask_lo,
                         self.mask_hi)
        d = trilinear(self.mask[..., None], idx, "zeros")[:, 0]
        alpha = 1.0 - torch.exp(-torch.nn.functional.softplus(
            d + self.act_shift, beta=1.0, threshold=1e9))
        return (alpha >= self.mask_thres).reshape(shape)

    @torch.no_grad()
    def nonempty(self):
        """``[X, Y, Z]`` bool: the voxel centres inside the mask."""
        axes = [torch.linspace(float(self.xyz_min[i]), float(self.xyz_max[i]),
                               n, device=self.device)
                for i, n in enumerate(self.world_size)]
        xyz = torch.stack(torch.meshgrid(*axes, indexing="ij"), -1)
        return torch.cat([self.in_mask(x[None])
                          for x in xyz.unbind(0)], 0)


def mask_density(scene: dict) -> np.ndarray:
    """``[R, R, R]`` float32: the ball scene's density, ``inside`` within
    ``radius`` of the box centre and ``outside`` elsewhere."""
    r = int(scene["mask_res"])
    g = np.linspace(-1.0, 1.0, r)
    xx, yy, zz = np.meshgrid(g, g, g, indexing="ij")
    rad = np.sqrt(xx ** 2 + yy ** 2 + zz ** 2)
    return np.where(rad < float(scene["radius"]), float(scene["inside"]),
                    float(scene["outside"])).astype(np.float32)


def trilinear(grid, idx, mode: str):
    """Trilinear sample of ``grid [X, Y, Z, C]`` at fractional indices
    ``idx [M, 3]``. ``zeros``: corners outside the grid weigh 0;
    ``border``: the coordinates clamp to the grid. Differentiable in
    ``grid`` (its gradient by autograd's index accumulation)."""
    X, Y, Z, C = grid.shape
    size = torch.tensor([X, Y, Z], device=idx.device)
    if mode == "border":
        u = torch.minimum(torch.clamp(idx, min=0.0), (size - 1).to(idx.dtype))
        i0 = torch.minimum(torch.floor(u).long(), size - 2)
        i0 = torch.clamp(i0, min=0)
        f = u - i0
    else:
        i0 = torch.floor(idx).long()
        f = idx - i0
    flat = grid.reshape(-1, C)
    out = 0.0
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                c = i0 + torch.tensor([dx, dy, dz], device=idx.device)
                w = ((f[:, 0] if dx else 1 - f[:, 0])
                     * (f[:, 1] if dy else 1 - f[:, 1])
                     * (f[:, 2] if dz else 1 - f[:, 2]))
                ok = ((c >= 0) & (c < size)).all(-1)
                cc = torch.minimum(torch.clamp(c, min=0), size - 1)
                lin = (cc[:, 0] * Y + cc[:, 1]) * Z + cc[:, 2]
                out = out + flat[lin] * (w * ok)[:, None]
    return out


# ----------------------------------------------------------------- weights


def head_dims(cfg: dict) -> Dict[str, List[int]]:
    """Layer widths of the two radiance heads and the tone-mapper."""
    m = cfg["app"]["model"]
    D = len(m["grad_feat"])
    dim0 = ((3 + 3 * m["posbase_pe"] * 2) + 3 * m["viewbase_pe"] * 3
            + m["color_dim"] + D * 3 + D * 6 + 1)
    rgb = [dim0] + [m["rgbnet_width"]] * (m["rgbnet_depth"] - 1) + [3]
    tm = ([3 + 3 * m["colorbase_pe"] * 2]
          + [m["tonemap_width"]] * (m["tonemap_depth"] - 1) + [3])
    return {"off_rgbnet": rgb, "emo_rgbnet": rgb, "tonemapper": tm}


def train_flops(config: dict, counters: Dict[str, float]) -> float:
    """Matrix-multiply operations of one train step: the two radiance heads
    and the tone-mapper once forward and once backward (twice the forward)
    for each of the step's ``head_samples``; nothing is recomputed."""
    dims = head_dims(config["cfg"])
    fwd = sum(head_flops(d) for d in dims.values())
    return 3.0 * fwd * counters["head_samples"]


def eval_flops(config: dict, counters: Dict[str, float]) -> float:
    """Matrix-multiply operations of one eval march's ``head_samples``: the
    radiance heads once and the tone-mapper three times (off, on,
    emission)."""
    dims = head_dims(config["cfg"])
    return (head_flops(dims["off_rgbnet"]) + head_flops(dims["emo_rgbnet"])
            + 3.0 * head_flops(dims["tonemapper"])) * counters["head_samples"]


@torch.no_grad()
def make_weights(config: dict, seed: int, device) -> dict:
    """The benchmark's weights from ``seed``, on ``device``, in a few large
    draws of a device generator: the unit-sphere SDF (+1 outside the
    mask), colour grids ``N(0, colour_std)``, and heads ``U(-1/sqrt(fan_in),
    1/sqrt(fan_in))``. The program's parameter layout: ``[X, Y, Z, C]``
    grids, heads as ``w{i} [in, out]`` / ``b{i}``."""
    cfg, scene = config["cfg"], config["scene"]
    geo = Geometry(cfg, scene, device)
    dev = geo.device
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    X, Y, Z = geo.world_size
    C = int(cfg["app"]["model"]["color_dim"])
    axes = [torch.linspace(-1.0, 1.0, n, device=dev) for n in (X, Y, Z)]
    gx, gy, gz = torch.meshgrid(*axes, indexing="ij")
    sdf = torch.sqrt(gx * gx + gy * gy + gz * gz) - 1.0
    sdf = torch.where(geo.nonempty(), sdf, torch.ones_like(sdf))[..., None]
    colours = torch.randn((2, X, Y, Z, C), generator=gen, device=dev)
    colours *= float(scene["colour_std"])
    w = {"sdf": sdf.contiguous(), "off_color": colours[0],
         "emo_color": colours[1]}
    dims = head_dims(cfg)
    n = sum(a * b + b for d in dims.values() for a, b in zip(d, d[1:]))
    u = torch.rand((n,), generator=gen, device=dev)
    at = 0
    for name, d in dims.items():
        head = {}
        for i, (a, b) in enumerate(zip(d, d[1:])):
            bound = 1.0 / math.sqrt(a)
            for key, shape in ((f"w{i}", (a, b)), (f"b{i}", (b,))):
                k = int(np.prod(shape))
                head[key] = (u[at:at + k] * (2 * bound) - bound).reshape(shape)
                at += k
        w[name] = head
    return w


# -------------------------------------------------------------- the march


def exclusive_cumprod(x):
    c = torch.cumprod(x, -1)
    return torch.cat([torch.ones_like(c[..., :1]), c[..., :-1]], -1)


def transmittance(alpha, early_exit=EARLY_EXIT_T):
    """Weights ``[N, S]`` and the transmittance after the last sample
    ``[N]``. A sample counts while the transmittance entering it is at
    least ``early_exit``; the rest get weight 0 (no gradient through the
    exit)."""
    live = exclusive_cumprod(1.0 - alpha).detach() >= early_exit
    a = torch.where(live, alpha, torch.zeros_like(alpha))
    t_in = exclusive_cumprod(1.0 - a)
    return a * t_in, t_in[:, -1] * (1.0 - a[:, -1])


def neighbour(x, ok, direction: int):
    """Per sample, ``x`` at the nearest kept sample after it (``+1``) or
    before it (``-1``) on the same ray, and whether there is one."""
    if direction < 0:
        v, has = neighbour(torch.flip(x, [-1]), torch.flip(ok, [-1]), 1)
        return torch.flip(v, [-1]), torch.flip(has, [-1])
    S = x.shape[-1]
    pos = torch.arange(S, device=x.device).expand(x.shape)
    idx = torch.where(ok, pos, torch.full_like(pos, S))
    later = torch.cat([idx[..., 1:], torch.full_like(idx[..., :1], S)], -1)
    nxt = torch.flip(torch.cummin(torch.flip(later, [-1]), -1).values, [-1])
    has = nxt < S
    return torch.gather(x, -1, torch.clamp(nxt, max=S - 1)), has


def neus_alpha(sdf, ok, s_val):
    """Interp-variant NeuS alpha on ``[N, S]``: the section of each kept
    sample runs between its midpoints with the previous and the next kept
    sample of the ray (itself where there is none)."""
    nxt, has_n = neighbour(sdf, ok, 1)
    prv, has_p = neighbour(sdf, ok, -1)
    e_next = torch.where(has_n, 0.5 * (sdf + nxt), sdf)
    e_prev = torch.where(has_p, 0.5 * (sdf + prv), sdf)
    c_prev = torch.sigmoid(e_prev * s_val)
    c_next = torch.sigmoid(e_next * s_val)
    a = torch.clamp((torch.relu(c_prev - c_next) + 1e-5) / (c_prev + 1e-5),
                    0.0, 1.0)
    return torch.where(ok, a, torch.zeros_like(a))


def march(geo: Geometry, sdf_grid, rays_o, rays_d, s_val, thres):
    """The fine march on dense samples. Returns the samples that reach the
    heads (``ray``, ``step``, ``pts``, ``w``, ``sdf``) and the per-ray
    transmittance after the last sample."""
    N, S = rays_o.shape[0], geo.n_samples
    vec = torch.where(rays_d == 0, torch.full_like(rays_d, 1e-6), rays_d)
    ra, rb = (geo.hi - rays_o) / vec, (geo.lo - rays_o) / vec
    t_min = torch.clamp(torch.minimum(ra, rb).amax(-1), geo.near, 1e9)
    t_max = torch.clamp(torch.maximum(ra, rb).amin(-1), geo.near, 1e9)
    rnorm = torch.sqrt((rays_d * rays_d).sum(-1))
    n_steps = torch.clamp(torch.ceil((t_max - t_min) * rnorm / geo.stepdist),
                          min=1.0)
    start = rays_o + rays_d * t_min[:, None]
    dirn = rays_d / rnorm[:, None]
    steps = torch.arange(S, dtype=torch.float32, device=rays_o.device)
    sd = geo.stepdist * steps
    pts = start[:, None, :] + dirn[:, None, :] * sd[None, :, None]
    with torch.no_grad():
        ok = (steps[None, :] < n_steps[:, None]) \
            & ((pts >= geo.lo) & (pts <= geo.hi)).all(-1)
        ok &= geo.in_mask(pts)
    sel = ok.reshape(-1).nonzero()[:, 0]
    sdf_s = trilinear(sdf_grid, geo.index(pts.reshape(-1, 3)[sel],
                                          geo.world_size), "zeros")[:, 0]
    sdf_d = torch.zeros(N * S, device=rays_o.device).index_put(
        (sel,), sdf_s).reshape(N, S)
    alpha = neus_alpha(sdf_d, ok, s_val)
    a1 = torch.where(alpha > thres, alpha, torch.zeros_like(alpha))
    w, last = transmittance(a1)
    keep = (w > thres).reshape(-1).nonzero()[:, 0]
    return {"ray": keep // S, "step": keep % S,
            "pts": pts.reshape(-1, 3)[keep].detach(),
            "w": w.reshape(-1)[keep], "sdf": sdf_d.reshape(-1)[keep],
            "last": last}


# ------------------------------------------------------- features, heads


def sdf_taps(geo: Geometry, sdf_grid, pts, displace: Sequence[float]):
    """SDF taps at ``pts +- d`` voxels along z, y and x (border mode)
    ``[M, 6 D]`` and the normals of their differences ``[M, 3 D]``."""
    size = geo.world_size
    ind = geo.index(pts, size)
    hi = torch.tensor([s - 1.0 for s in size], device=pts.device)
    base = torch.minimum(torch.clamp(ind, min=0.0), hi)
    taps, grads = [], []
    for axis in (2, 1, 0):
        per_sign = []
        for sign in (-1.0, 1.0):
            cols = []
            for d in displace:
                q = base.clone()
                q[:, axis] = torch.clamp(ind[:, axis] + sign * d, 0.0,
                                         size[axis] - 1.0)
                cols.append(trilinear(sdf_grid, q, "border")[:, 0])
            per_sign.append(torch.stack(cols, -1))  # [M, D]
        taps += per_sign
        dd = torch.tensor([float(d) for d in displace], device=pts.device)
        qp = torch.clamp(ind[:, axis, None] + dd, 0.0, size[axis] - 1.0)
        qm = torch.clamp(ind[:, axis, None] - dd, 0.0, size[axis] - 1.0)
        grads.append((per_sign[1] - per_sign[0]) / (qp - qm) / geo.voxel_size)
    g = torch.stack(grads, 1)  # [M, 3 (z, y, x), D]
    nrm = g / torch.clamp(torch.linalg.vector_norm(g, dim=1, keepdim=True),
                          min=1e-12)
    M, D = pts.shape[0], len(displace)
    return torch.stack(taps, 1).reshape(M, 6 * D), nrm.reshape(M, 3 * D), g


def encode(x, n_freq: int, with_x: bool = True):
    """``[x, sin(x 2^k), cos(x 2^k)]`` for ``k < n_freq`` (per coordinate,
    frequencies minor); without ``x`` the scaled values lead instead."""
    f = torch.tensor([2.0 ** k for k in range(n_freq)], device=x.device)
    e = (x[..., None] * f).reshape(*x.shape[:-1], x.shape[-1] * n_freq)
    return torch.cat([x if with_x else e, torch.sin(e), torch.cos(e)], -1)


class _Fp8(torch.autograd.Function):
    """Round to float8 e4m3 with a per-tensor scale, and the gradient
    likewise."""

    @staticmethod
    def forward(ctx, x):
        return fp8_round(x)

    @staticmethod
    def backward(ctx, g):
        return fp8_round(g)


def fp8_round(x):
    if x.numel() == 0:
        return x
    s = torch.clamp(x.detach().abs().amax(), min=1e-30) / FP8_MAX
    return (x / s).to(torch.float8_e4m3fn).to(torch.float32) * s


def mlp(head: dict, x, precision: str):
    q = {"fp8": _Fp8.apply,
         "bf16": lambda t: t.to(torch.bfloat16).to(torch.float32)}.get(
        precision, lambda t: t)
    L = sum(1 for k in head if k.startswith("w"))
    for i in range(L):
        x = q(x) @ q(head[f"w{i}"]) + q(head[f"b{i}"])
        if i < L - 1:
            x = torch.relu(x)
    return x


class Model:
    """The fine renderer on the reference's geometry."""

    def __init__(self, cfg: dict, scene: dict, device,
                 precision: str = "f32"):
        if precision not in ("f32", "bf16", "fp8"):
            raise ValueError(f"unknown precision {precision!r}")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.cfg, self.m = cfg, cfg["app"]["model"]
        self.geo = Geometry(cfg, scene, device)
        self.precision = precision
        self.thres = float(self.m["fastcolor_thres"])

    def features(self, p, pts, vd, sdf):
        g = self.geo
        xyz_n = (pts - g.lo) / (g.hi - g.lo)
        taps, nrm, _ = sdf_taps(g, p["sdf"], pts, self.m["grad_feat"])
        return torch.cat([encode(xyz_n, self.m["posbase_pe"]),
                          encode(vd, self.m["viewbase_pe"], with_x=False),
                          sdf[:, None], taps, nrm], -1)

    def radiance(self, p, head, grid_val, feat):
        return torch.nn.functional.softplus(
            mlp(p[head], torch.cat([grid_val, feat], -1), self.precision))

    def tonemap(self, p, lin):
        return torch.sigmoid(mlp(p["tonemapper"],
                                 encode(lin, self.m["colorbase_pe"]),
                                 self.precision))

    def samples(self, p, rays_o, rays_d, viewdirs, s_val):
        mk = march(self.geo, p["sdf"], rays_o, rays_d, s_val, self.thres)
        pts = mk["pts"]
        feat = self.features(p, pts, viewdirs[mk["ray"]], mk["sdf"])
        idx = self.geo.index(pts, self.geo.world_size)
        off_gv = trilinear(p["off_color"], idx, "zeros")
        emo_gv = trilinear(p["emo_color"], idx, "zeros")
        return mk, feat, off_gv, emo_gv

    @staticmethod
    def per_ray(mk, n_rays, v):
        w = mk["w"][:, None] if v.dim() == 2 else mk["w"]
        out = torch.zeros((n_rays, *v.shape[1:]), device=v.device)
        return out.index_add(0, mk["ray"], w * v)

    def forward_training(self, p, rays_o, rays_d, viewdirs, em_modes, s_val):
        mk, feat, off_gv, emo_gv = self.samples(p, rays_o, rays_d, viewdirs,
                                                s_val)
        off = self.radiance(p, "off_rgbnet", off_gv, feat)
        emo = self.radiance(p, "emo_rgbnet", emo_gv, feat)
        on = (em_modes[mk["ray"]] == 1)[:, None]
        lin = torch.where(on, emo + off.detach(), off)
        rgb = self.tonemap(p, lin)
        N = rays_o.shape[0]
        return {"rgb": self.per_ray(mk, N, rgb),
                "lin": self.per_ray(mk, N, lin), "last": mk["last"],
                "n_head": int(mk["ray"].numel())}

    @torch.no_grad()
    def forward_evaluate(self, p, rays_o, rays_d, viewdirs, em_mode: int,
                         pos_rt, s_val) -> Dict[str, torch.Tensor]:
        mk, feat, off_gv, emo_gv = self.samples(p, rays_o, rays_d, viewdirs,
                                                s_val)
        lin_off = self.radiance(p, "off_rgbnet", off_gv, feat)
        lin_emo = self.radiance(p, "emo_rgbnet", emo_gv, feat)
        lin_on = lin_off + lin_emo
        _, _, g = sdf_taps(self.geo, p["sdf"], mk["pts"], (1.0,))
        grad = torch.stack([g[:, 2, 0], g[:, 1, 0], g[:, 0, 0]], -1)
        normal = grad / torch.clamp(torch.linalg.vector_norm(
            grad, dim=-1, keepdim=True), min=1e-12)
        flip = torch.tensor([1.0, -1.0, -1.0], device=normal.device)
        nrm = ((normal @ pos_rt) * flip + 1.0) / 2.0
        N = rays_o.shape[0]
        out = {k: self.per_ray(mk, N, v) for k, v in (
            ("srgb/off_rgb", self.tonemap(p, lin_off)),
            ("lin/off_rgb", lin_off),
            ("srgb/on_rgb", self.tonemap(p, lin_on)), ("lin/on_rgb", lin_on),
            ("srgb/emo_rgb", self.tonemap(p, lin_emo)),
            ("lin/emo_rgb", lin_emo), ("etc/normal", nrm))}
        depth = self.per_ray(mk, N, mk["step"].to(torch.float32)
                             * self.geo.stepdist)
        tag = "off" if int(em_mode) == 0 else "on"
        out.update({"etc/depth": depth,
                    "etc/disp": 1.0 / (depth + mk["last"] * self.geo.far),
                    "etc/white_bg": mk["last"][:, None],
                    "srgb/rgb": out[f"srgb/{tag}_rgb"],
                    "lin/rgb": out[f"lin/{tag}_rgb"]})
        return out


# ------------------------------------------------------ loss and the step


def gamma(x):
    """Linear -> sRGB."""
    return torch.where(x <= 0.0031308, 12.92 * x,
                       1.055 * torch.pow(torch.clamp(x, min=1e-12), 1 / 2.4)
                       - 0.055)


def sdf_gradient(geo: Geometry, sdf):
    """Central differences of ``sdf [X, Y, Z, 1]``, zero on the border:
    ``[X, Y, Z, 3]``."""
    g = sdf[..., 0]
    s = 2 * geo.voxel_size
    gx = torch.nn.functional.pad((g[2:] - g[:-2]) / s, (0, 0, 0, 0, 1, 1))
    gy = torch.nn.functional.pad((g[:, 2:] - g[:, :-2]) / s, (0, 0, 1, 1))
    gz = torch.nn.functional.pad((g[:, :, 2:] - g[:, :, :-2]) / s, (1, 1))
    return torch.stack([gx, gy, gz], -1)


def smooth(x):
    """The 3x3x3 binomial filter ([1, 2, 1] / 4 per axis) with replicated
    borders, on ``[X, Y, Z, C]``."""
    for axis in range(3):
        n = x.shape[axis]
        pad = torch.cat([x.narrow(axis, 0, 1), x, x.narrow(axis, n - 1, 1)],
                        axis)
        x = (0.25 * pad.narrow(axis, 0, n) + 0.5 * pad.narrow(axis, 1, n)
             + 0.25 * pad.narrow(axis, 2, n))
    return x


def smooth_grad_tv(geo: Geometry, sdf, nonempty, weight):
    g = sdf_gradient(geo, sdf)
    err = (smooth(g).detach() - g) ** 2
    mask = nonempty[..., None].expand(err.shape)
    return (err * mask).sum() / torch.clamp(mask.sum(), min=1) * weight


def sdf_tv_grad(sdf, w):
    """``w / 6`` times the sum over the grid neighbours of ``clamp(v -
    neighbour, -1, 1)``."""
    out = torch.zeros_like(sdf)
    for axis in range(3):
        n = sdf.shape[axis]
        d = torch.clamp(sdf.narrow(axis, 1, n - 1)
                        - sdf.narrow(axis, 0, n - 1), -1.0, 1.0)
        out.narrow(axis, 1, n - 1).add_(d)
        out.narrow(axis, 0, n - 1).sub_(d)
    return out * (w / 6.0)


def cosine_scale(cfg: dict, step: int) -> float:
    """The trainer's cosine learning-rate factor at ``step`` (no warm-up in
    the fine stage's configuration)."""
    tr = cfg["app"]["trainer"]
    w = int(tr["warm_up_iters"])
    if w:
        raise ValueError("the reference's schedule has no warm-up")
    lo = float(tr["cos_min_ratio"])
    return (1 + math.cos(step / int(tr["n_iters"]) * math.pi)) * 0.5 \
        * (1 - lo) + lo


def lr_scale(cfg: dict, group: str, step: int) -> float:
    """The factor on ``group``'s learning rate at ``step`` of a run that
    began at step 0: the cosine factor of the step before, and every
    ``decay_steps`` entry before ``step``."""
    s = 1.0 if step == 0 else cosine_scale(cfg, step - 1)
    for at, groups in cfg["app"]["trainer"]["decay_steps"].items():
        if int(at) < step and group in groups:
            s *= float(groups[group])
    return s


def leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from leaves(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def train_steps(config: dict, weights: dict, batches: List[dict], device,
                precision: str = "f32") -> dict:
    """The fine stage's train steps from the configuration's ``first_step``
    on, from ``weights`` on ``batches`` (one each). Returns each step's
    ``(mse, lin_mse)``, the first step's gradient per leaf as Adam takes
    it, and the parameters after the steps (on ``device``)."""
    cfg, scene = config["cfg"], config["scene"]
    first_step, s_val = int(config["first_step"]), float(scene["s_val"])
    model = Model(cfg, scene, device, precision)
    geo, tr = model.geo, cfg["app"]["trainer"]
    nonempty = geo.nonempty()
    p = {k: ({j: t.to(device).clone() for j, t in v.items()}
             if isinstance(v, dict) else v.to(device).clone())
         for k, v in weights.items()}
    mom = {name: [torch.zeros_like(t), torch.zeros_like(t)]
           for name, t in leaves(p)}
    lrs = {k: float(v) for k, v in tr["lrs"].items()}
    b1, b2, eps = 0.9, 0.99, 1e-8
    white_bg = 1.0 if cfg["data"]["white_bg"] else 0.0
    out = {"losses": [], "grads": None, "n_head": []}
    for j, batch in enumerate(batches):
        i = first_step + j
        b = {k: torch.as_tensor(v).to(device) for k, v in batch.items()}
        named = dict(leaves(p))
        for t in named.values():
            t.requires_grad_(True)
        res = model.forward_training(p, b["rays_o"], b["rays_d"],
                                     b["viewdirs"], b["em_modes"], s_val)
        wbg = res["last"][:, None] * white_bg
        srgb = torch.clamp(res["rgb"] + wbg, 0.0, 1.0)
        lin = torch.clamp(res["lin"] + wbg, min=0.0)
        mse = ((srgb - b["rgbs"]) ** 2).mean()
        tone = torch.where(b["rgbs"] >= 1, torch.clamp(lin, max=1.0), lin)
        lin_mse = ((gamma(tone) - b["rgbs"]) ** 2).mean()
        pout = torch.clamp(res["last"][-1], 1e-6, 1 - 1e-6)
        ent = -(pout * torch.log(pout) + (1 - pout) * torch.log(1 - pout))
        loss = (mse + float(tr["weight_linear"]) * lin_mse
                + float(tr["weight_entropy_last"]) * ent)
        tv_on = (tr["tv_from"] < i < tr["tv_end"]) and i % tr["tv_every"] == 0
        if tv_on:
            loss = loss + smooth_grad_tv(geo, p["sdf"], nonempty,
                                         float(tr["tvs"]["smooth_grad"]))
        names = list(named)
        grads = torch.autograd.grad(loss, [named[n] for n in names],
                                    allow_unused=True)
        g = {n: (torch.zeros_like(named[n]) if x is None else x)
             for n, x in zip(names, grads)}
        if tv_on:
            w = (float(tr["weight_tv_density"]) * float(tr["tvs"]["sdf"])
                 / b["rays_o"].shape[0] * max(geo.world_size) / 128.0)
            sparse = i >= int(tr["tv_dense_before"])
            tvg = sdf_tv_grad(p["sdf"].detach(), w)
            if sparse:
                tvg = torch.where(g["sdf"] == 0, torch.zeros_like(tvg), tvg)
            g["sdf"] = g["sdf"] + tvg
        if j == 0:
            out["grads"] = {n: x.detach().clone() for n, x in g.items()}
        out["losses"].append((float(mse.detach()), float(lin_mse.detach())))
        out["n_head"].append(res["n_head"])
        with torch.no_grad():
            t = j + 1
            for n in names:
                group = n.split(".")[0]
                lr = lrs[group] * lr_scale(cfg, group, i)
                m, v = mom[n]
                m.mul_(b1).add_(g[n], alpha=1 - b1)
                v.mul_(b2).addcmul_(g[n], g[n], value=1 - b2)
                denom = torch.sqrt(v) / math.sqrt(1 - b2 ** t) + eps
                named[n].requires_grad_(False)
                named[n].sub_(lr / (1 - b1 ** t) * m / denom)
    out["params"] = dict(leaves(p))
    return out


@torch.no_grad()
def eval_chunks(config: dict, weights: dict, chunks, device,
                precision: str = "f32") -> List[Dict[str, np.ndarray]]:
    """The eval outputs of each chunk ``(view, start, end)`` of the traffic's
    views, on the host."""
    model = Model(config["cfg"], config["scene"], device, precision)
    p = {k: ({j: t.to(device) for j, t in w.items()} if isinstance(w, dict)
             else w.to(device)) for k, w in weights.items()}
    s_val = float(config["scene"]["s_val"])
    out = []
    for v, st, en in chunks:
        arr = [torch.as_tensor(v[k][st:en], device=device)
               for k in ("rays_o", "rays_d", "viewdirs")]
        r = model.forward_evaluate(p, *arr, v["em_mode"],
                                   torch.as_tensor(v["pose"], device=device),
                                   s_val)
        out.append({k: t.cpu().numpy() for k, t in r.items()})
    return out
