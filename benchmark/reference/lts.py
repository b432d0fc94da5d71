"""Plain PyTorch reference of the LTS stage (ESRNeRF) for the benchmark.

It follows the LTS stage's description (ESR-NeRF, CVPR 2024: light
transport segments) as the configuration file states it, in float32 with
TF32 off, and imports nothing of the program under test. From the fine
stage's reference (:mod:`benchmark.reference.fine`) it takes the scene's
geometry and occupancy mask, the trilinear sampler, the NeuS alpha and the
transmittance, the head features, the MLPs, the tone-mapper, the TV terms
and the learning-rate schedule. Its own:

- the banded dense march, primary and secondary: every ray sampled
  densely at ``stepsize`` voxels from its box entry (from ``lts_near`` for
  the secondary rays, which start at surface points), the samples inside
  the mask and inside the SDF surface band kept, then the fine march's
  alpha, pre-filter, scan with its early exit and ``weight >
  fastcolor_thres`` survivors. No sample budget: the program's must drop
  nothing;
- the keyed draws, rebuilt here with their own copy of the hash: each
  live sample's selection score and its normal and emission perturbations
  from (seed, step, the ray's place in the batch, the sample's index along
  the ray), each chosen point's scattering normals from its (ray, sample);
- the selection: the ``num_ltspts`` lowest scores among the live samples,
  ties to the lower (ray, sample);
- the expected SDF gradient (the trilinear interpolant's spatial
  gradient), its unit normal, BRDFNet and EmissionNet, the hemisphere
  scattering, the Disney BRDF, the spherical-Gaussian envmap and the
  secondary rays' incoming radiance;
- the whole LTS loss (sRGB and linear MSE, the masked off / emo
  reconstruction MSEs of both outgoing directions, the last ray's entropy,
  the normal smoothness, the smooth-gradient TV), the SDF TV gradient, and
  Adam over every group.

Departures from the published description, each the configuration's:

- the surface band (``surf_band_factor``, no upstream analogue): a sample
  is kept only inside a 64^3 block of the box whose SDF range, over a
  lattice of the grid's points (:func:`band_blocks`), meets ``[-band,
  band]`` (``band = surf_band_factor / s``), or in a block next to one.
  The rule is the configuration's as the port defines it, block for
  block: a ray that starts inside the surface takes its first opaque
  sample at the band's edge, so the edge decides the result;
- the randomness is keyed (above), not a generator's stream: upstream
  draws the same distributions (a uniform choice of live samples, normal
  scattering and perturbation draws) from a stream;
- the LTS loss has no emission smoothness term and the eps-perturbed BRDF
  re-evaluation enters no loss, as in the program; the reference leaves it
  out (``train_flops`` counts it, the program computes it).

``precision="fp8"`` rounds every head operand to float8 e4m3 (the
control); ``"bf16"`` to bfloat16 as the program's heads.

The harness finds this module by the configuration's ``stage`` and calls
``make_weights``, ``train_steps``, ``leaves`` and ``train_flops``.
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch

from benchmark.harness.flops import head_flops
from benchmark.reference import fine as F
from benchmark.reference.fine import leaves  # noqa: F401  (the harness's)

# dense secondary samples marched at once (rays x samples)
SECONDARY_CHUNK = 1 << 22

# ------------------------------------------------------------ keyed draws

M32 = 0xFFFFFFFF


def _mix32(x: int) -> int:
    x ^= x >> 16
    x = (x * 0x7FEB352D) & M32
    x ^= x >> 15
    x = (x * 0x846CA68B) & M32
    return x ^ (x >> 16)


def _mul32(x, c: int):
    """``x * c mod 2**32`` on int64 tensors below 2**32, in 16-bit halves
    (no int64 product overflows)."""
    return (x * (c & 0xFFFF) + (((x * (c >> 16)) & 0xFFFF) << 16)) & M32


def _mix32_t(x):
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def key_state(seed: int, step: int) -> int:
    """The hash state after the run's seed and the step (each two 32-bit
    words), from the fixed start ``0x243F6A88``."""
    h = 0x243F6A88
    for w in (int(seed), int(step)):
        w &= (1 << 64) - 1
        h = _mix32(h ^ (w & M32))
        h = _mix32(h ^ (w >> 32))
    return h


def sample_hash(state: int, ray, sample):
    """int64 hash states of samples ``(ray, sample)``."""
    h = _mix32_t(ray.to(torch.int64) ^ state)
    return _mix32_t(h ^ sample.to(torch.int64))


def lane_hash(h, lanes: range):
    lane = torch.tensor(list(lanes), dtype=torch.int64, device=h.device)
    return _mix32_t(h[..., None] ^ lane)


def to_uniform(h):
    return (h >> 8).to(torch.float32) / float(1 << 24)


def to_normal(h):
    """Box-Muller over lane pairs (radius lane, angle lane)."""
    u1 = ((h[..., 0::2] >> 8) + 1).to(torch.float32) / float(1 << 24)
    u2 = (h[..., 1::2] >> 8).to(torch.float32) / float(1 << 24)
    return torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(2.0 * math.pi * u2)


# a sample's lanes: score 0, normal eps 1-6, emission eps 7-12; a chosen
# point's scattering normals from lane 16 on
SCATTER_LANE = 16


# ----------------------------------------------------------------- weights


def head_dims(cfg: dict) -> Dict[str, List[int]]:
    """Layer widths of every head: the fine stage's three, BRDFNet (5:
    basecolour, roughness, metallic) and EmissionNet (3)."""
    m = cfg["app"]["model"]
    dims = F.head_dims(cfg)
    D = len(m["grad_feat"])
    dim0 = (3 + 3 * m["posbase_pe"] * 2) + m["color_dim"] + D * 3 + D * 6 + 1
    hidden = [m["brdfnet_width"]] * (m["brdfnet_depth"] - 1)
    dims["brdfnet"] = [dim0] + hidden + [5]
    dims["emitnet"] = [dim0] + hidden + [3]
    return dims


def train_flops(config: dict, counters: Dict[str, float]) -> float:
    """Matrix-multiply operations of one train step, from the counters of
    both marches: per primary head row the two radiance heads, the
    tone-mapper, BRDFNet and EmissionNet (x3: forward and backward) and
    BRDFNet and EmissionNet again at the eps-perturbed points (forward
    alone: no loss reads them); per chosen point the two radiance heads at
    both outgoing directions, per secondary head row the two radiance
    heads (x3)."""
    d = {k: head_flops(v) for k, v in head_dims(config["cfg"]).items()}
    rad, brdf = d["off_rgbnet"] + d["emo_rgbnet"], d["brdfnet"] + d["emitnet"]
    return (counters["head_rows"] * (3.0 * (rad + d["tonemapper"] + brdf)
                                     + brdf)
            + 3.0 * rad * (2.0 * counters["points"]
                           + counters["head_rows_2nd"]))


@torch.no_grad()
def make_weights(config: dict, seed: int, device) -> dict:
    """The fine stage's weights from ``seed`` (:func:`benchmark.reference.
    fine.make_weights`) and, from a generator seeded with ``seed + 1``: a
    BRDF grid ``N(0, colour_std)``, BRDFNet and EmissionNet ``U(-1 /
    sqrt(fan_in), 1 / sqrt(fan_in))``, and the SG envmap (the energy-
    normalised lobes of normal draws, softplus activation)."""
    cfg, scene = config["cfg"], config["scene"]
    m = cfg["app"]["model"]
    if m["env_activation"] != "softplus":
        raise ValueError("the reference's envmap is the softplus one")
    w = F.make_weights(config, seed, device)
    dev = w["sdf"].device
    gen = torch.Generator(device=dev).manual_seed(int(seed) + 1)
    X, Y, Z, _ = w["sdf"].shape
    C = int(m["color_dim"])
    w["brdf"] = torch.randn((X, Y, Z, C), generator=gen, device=dev) \
        * float(scene["colour_std"])
    for name in ("brdfnet", "emitnet"):
        d = head_dims(cfg)[name]
        head = {}
        for i, (a, b) in enumerate(zip(d, d[1:])):
            bound = 1.0 / math.sqrt(a)
            for key, shape in ((f"w{i}", (a, b)), (f"b{i}", (b,))):
                u = torch.rand(shape, generator=gen, device=dev)
                head[key] = u * (2 * bound) - bound
        w[name] = head
    K = int(m["env_sg"])
    mus = torch.randn((K, 3), generator=gen, device=dev)
    lam = 10.0 + torch.abs(torch.randn((K, 1), generator=gen, device=dev)
                           * 20.0)
    lobes = torch.randn((K, 3), generator=gen, device=dev)
    sp = torch.nn.functional.softplus(mus)
    energy = sp * 2.0 * math.pi / lam * (1.0 - torch.exp(-2.0 * lam))
    norm = sp / energy.sum(0, keepdim=True) * 2.0 * math.pi * 0.8
    w["envmap"] = {"mus": torch.log(torch.expm1(norm)), "lambdas": lam,
                   "lobes": lobes}
    return w


# -------------------------------------------------------------- the march


@torch.no_grad()
def band_blocks(sdf_grid, band: float):
    """``[64, 64, 64]`` bool: the 64^3 blocks of the box kept by the surface
    band. Per axis of ``n`` grid points the SDF is resampled onto a lattice
    of ``LAT = 64 ceil(n / 64)`` points (point ``k`` at grid index
    ``round((k + 0.5) (n - 1) / LAT)``); each block takes the SDF's range
    over ``p + 1`` lattice points from its own first (``p = LAT / 64``, the
    last point repeated past the end), is kept where the range meets
    ``[-band, band]``, and the kept blocks are dilated by one block."""
    g = sdf_grid[..., 0]
    lo_t = hi_t = g
    for axis in range(3):
        n = g.shape[axis]
        LAT = 64 * -(-n // 64)
        p = LAT // 64
        k = np.arange(LAT + 1)
        idx = np.clip(np.round((np.minimum(k, LAT - 1) + 0.5) / LAT
                               * (n - 1)), 0, n - 1).astype(np.int64)
        win = torch.as_tensor(idx[np.arange(64)[:, None] * p
                                  + np.arange(p + 1)[None, :]],
                              device=g.device)          # [64, p + 1]
        pick = lambda t: torch.stack([t.index_select(axis, win[:, j])
                                      for j in range(p + 1)], 0)
        lo_t, hi_t = pick(lo_t).amin(0), pick(hi_t).amax(0)
    ok = ((lo_t <= band) & (hi_t >= -band)).to(torch.float32)
    ok = torch.nn.functional.max_pool3d(ok[None, None], 3, stride=1,
                                        padding=1)[0, 0]
    return ok > 0


@torch.no_grad()
def _kept(geo: F.Geometry, blocks, rays_o, rays_d, near: float):
    """The dense samples of rays ``[n]``: their points ``[n, S, 3]`` and
    which are kept (inside the ray's span, the box, the mask and a band
    block)."""
    S = geo.n_samples
    vec = torch.where(rays_d == 0, torch.full_like(rays_d, 1e-6), rays_d)
    ra, rb = (geo.hi - rays_o) / vec, (geo.lo - rays_o) / vec
    t_min = torch.clamp(torch.minimum(ra, rb).amax(-1), near, 1e9)
    t_max = torch.clamp(torch.maximum(ra, rb).amin(-1), near, 1e9)
    rnorm = torch.sqrt((rays_d * rays_d).sum(-1))
    n_steps = torch.clamp(torch.ceil((t_max - t_min) * rnorm / geo.stepdist),
                          min=1.0)
    start = rays_o + rays_d * t_min[:, None]
    dirn = rays_d / rnorm[:, None]
    steps = torch.arange(S, dtype=torch.float32, device=rays_o.device)
    pts = start[:, None, :] + dirn[:, None, :] * (geo.stepdist
                                                  * steps)[None, :, None]
    ok = (steps[None, :] < n_steps[:, None]) \
        & ((pts >= geo.lo) & (pts <= geo.hi)).all(-1)
    blk = torch.clamp(torch.floor((pts - geo.lo) / (geo.hi - geo.lo) * 64),
                      0, 63).long()
    ok &= blocks[blk[..., 0], blk[..., 1], blk[..., 2]]
    ok &= geo.in_mask(pts)
    return pts, ok


def march(geo: F.Geometry, blocks, sdf_grid, rays_o, rays_d, s_val,
          thres: float, near: float, chunk_rays: int):
    """The banded fine-style march of rays ``[N]`` on dense samples (the
    kept samples found ``chunk_rays`` rays at a time). Returns the samples
    that reach the heads (``ray``, ``step``, ``pts``, ``w``, ``sdf``) and
    the per-ray transmittance after the last sample."""
    N, S = rays_o.shape[0], geo.n_samples
    sel, pts_k = [], []
    for a in range(0, N, chunk_rays):
        pts, ok = _kept(geo, blocks, rays_o[a:a + chunk_rays],
                        rays_d[a:a + chunk_rays], near)
        idx = ok.reshape(-1).nonzero()[:, 0]
        sel.append(idx + a * S)
        pts_k.append(pts.reshape(-1, 3)[idx])
    sel, pts_k = torch.cat(sel), torch.cat(pts_k)
    sdf_s = F.trilinear(sdf_grid, geo.index(pts_k, geo.world_size),
                        "zeros")[:, 0]
    dense = lambda v: torch.zeros(N * S, dtype=v.dtype,
                                  device=v.device).index_put(
        (sel,), v).reshape(N, S)
    ok = dense(torch.ones_like(sel, dtype=torch.bool))
    sdf_d = dense(sdf_s)
    alpha = F.neus_alpha(sdf_d, ok, s_val)
    a1 = torch.where(alpha > thres, alpha, torch.zeros_like(alpha))
    w, last = F.transmittance(a1)
    live = (w.reshape(-1)[sel] > thres).nonzero()[:, 0]
    keep = sel[live]
    return {"ray": keep // S, "step": keep % S, "pts": pts_k[live],
            "w": w.reshape(-1)[keep], "sdf": sdf_d.reshape(-1)[keep],
            "last": last}


# ------------------------------------------------------------- the model


def trilinear_grad(grid, idx, scale):
    """The zeros-mode trilinear interpolant's spatial gradient at
    fractional indices ``idx [M, 3]`` of ``grid [X, Y, Z, 1]``, times
    ``scale`` (index units per world unit): ``[M, 3]``."""
    X, Y, Z, _ = grid.shape
    size = torch.tensor([X, Y, Z], device=idx.device)
    i0 = torch.floor(idx).long()
    f = idx - i0
    flat = grid.reshape(-1)
    out = 0.0
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                c = i0 + torch.tensor([dx, dy, dz], device=idx.device)
                ok = ((c >= 0) & (c < size)).all(-1)
                cc = torch.minimum(torch.clamp(c, min=0), size - 1)
                v = flat[(cc[:, 0] * Y + cc[:, 1]) * Z + cc[:, 2]] * ok
                wx = f[:, 0] if dx else 1 - f[:, 0]
                wy = f[:, 1] if dy else 1 - f[:, 1]
                wz = f[:, 2] if dz else 1 - f[:, 2]
                d = torch.stack([(1 if dx else -1) * wy * wz,
                                 (1 if dy else -1) * wx * wz,
                                 (1 if dz else -1) * wx * wy], -1)
                out = out + v[:, None] * d
    return out * scale


def unit(v):
    return v / torch.clamp(torch.linalg.vector_norm(v, dim=-1, keepdim=True),
                           min=1e-12)


def disney(albedo, rough, metal, n, wi, wo):
    """The Disney-style BRDF response the model uses: ``(diffuse +
    specular) (n . wi) 2 pi``; SG-normalised D, Schlick F and
    Schlick-GGX V."""
    h = unit(wi + wo)
    dot = lambda a, b: (a * b).sum(-1, keepdim=True)
    noh = torch.clamp(dot(n, h), min=0.0)
    ooh = torch.clamp(dot(wo, h), min=0.0)
    ion = torch.clamp(dot(wi, n), min=0.0)
    oon = torch.clamp(dot(wo, n), min=0.0)
    diffuse = (1.0 - metal) * albedo / math.pi
    r2 = torch.clamp(rough * rough, min=1e-7)
    D = torch.exp((2.0 / r2) * (noh - 1.0)) / (r2 * math.pi)
    F0 = 0.04 * (1.0 - metal) + albedo * metal
    Fr = F0 + (1.0 - F0) * (1.0 - ooh) ** 5
    k = (1.0 + rough) ** 2 / 8.0
    V = (0.5 / torch.clamp(ion * (1.0 - k) + k, min=1e-7)) \
        * (0.5 / torch.clamp(oon * (1.0 - k) + k, min=1e-7))
    return (diffuse + D * Fr * V) * ion * 2.0 * math.pi


def envmap(env: dict, dirs):
    """The spherical-Gaussian mixture at unit directions (softplus)."""
    lobes = unit(env["lobes"])
    cos = (dirs[:, None, :] * lobes).sum(-1, keepdim=True)
    val = (env["mus"] * torch.exp(torch.abs(env["lambdas"]) * (cos - 1.0))
           ).sum(1)
    return torch.nn.functional.softplus(val)


class Model(F.Model):
    """The LTS renderer on the reference's geometry."""

    def __init__(self, cfg: dict, scene: dict, device,
                 precision: str = "f32"):
        super().__init__(cfg, scene, device, precision)
        m = self.m
        self.P = int(m["num_ltspts"])
        self.n2 = int(m["num_2ndrays"])
        self.near2 = float(m["lts_near"])
        self.band_factor = float(m["surf_band_factor"])
        if str(m["ray_sampling"]).lower() != "random":
            raise ValueError("the reference scatters by random draws")
        g = self.geo
        self.scale = torch.tensor([(s - 1.0) for s in g.world_size],
                                  device=g.lo.device) / (g.hi - g.lo)

    def brdf_heads(self, p, pts, sdf, taps, nrm):
        xyz_n = (pts - self.geo.lo) / (self.geo.hi - self.geo.lo)
        feat = torch.cat([F.encode(xyz_n, self.m["posbase_pe"]),
                          sdf[:, None], taps, nrm], -1)
        idx = self.geo.index(pts, self.geo.world_size)
        b = torch.sigmoid(F.mlp(p["brdfnet"], torch.cat(
            [F.trilinear(p["brdf"], idx, "zeros"), feat], -1),
            self.precision))
        emit = torch.nn.functional.softplus(F.mlp(p["emitnet"], torch.cat(
            [F.trilinear(p["emo_color"], idx, "zeros"), feat], -1),
            self.precision))
        return b[:, :3], b[:, 3:4], b[:, 4:5], emit

    def exp_grad(self, p, pts):
        return trilinear_grad(p["sdf"], self.geo.index(pts,
                                                        self.geo.world_size),
                              self.scale)

    def radiance_at(self, p, pts, vd, sdf, heads=("off", "emo")):
        """Each head's radiance at points ``pts`` seen along ``vd``."""
        feat = self.features(p, pts, vd, sdf)
        idx = self.geo.index(pts, self.geo.world_size)
        return [self.radiance(p, f"{h}_rgbnet",
                              F.trilinear(p[f"{h}_color"], idx, "zeros"),
                              feat) for h in heads]

    def forward_training(self, p, b, s_val, state: int, normal_eps: float):
        """The LTS forward on batch ``b`` under the key ``state``: the
        per-ray colours, the surface points' reconstruction pairs and the
        normal smoothness (the expected gradient at each live sample and at
        its normal-perturbed point)."""
        g, m = self.geo, self.m
        thres = self.thres
        blocks = band_blocks(p["sdf"].detach(),
                             float(np.float32(self.band_factor)
                                   / np.float32(s_val)))
        N = b["rays_o"].shape[0]
        mk = march(g, blocks, p["sdf"], b["rays_o"], b["rays_d"], s_val,
                   thres, g.near, N)
        pts, ray, vd = mk["pts"], mk["ray"], b["viewdirs"][mk["ray"]]
        off, emo = self.radiance_at(p, pts, vd, mk["sdf"])
        on = (b["em_modes"][ray] == 1)[:, None]
        lin = torch.where(on, emo + off, off)
        rgb = self.tonemap(p, lin)

        # keyed draws of the live samples
        h = sample_hash(state, ray, mk["step"])
        lanes = lane_hash(h, range(13))
        score, z = to_uniform(lanes[:, 0]), to_normal(lanes[:, 1:])
        grad = self.exp_grad(p, pts)
        normal = unit(grad).detach()
        grad_eps = self.exp_grad(p, pts + z[:, :3] * normal_eps)
        nsm = torch.abs(grad - grad_eps).sum() / max(3 * pts.shape[0], 1)

        # the surface points: lowest scores, ties to the lower (ray, sample)
        n_sel = min(self.P, pts.shape[0])
        order = torch.argsort(ray * (g.n_samples + 1) + mk["step"])
        order = order[torch.argsort(score[order], stable=True)][:n_sel]
        q, rs = pts[order], ray[order]
        taps, nrm, _ = F.sdf_taps(g, p["sdf"], q, m["grad_feat"])
        basecolor, rough, metal, emit = self.brdf_heads(
            p, q, mk["sdf"][order], taps, nrm)
        n = normal[order]
        zs = to_normal(lane_hash(h[order], range(
            SCATTER_LANE, SCATTER_LANE + 6 * (self.n2 + 1)))).reshape(
            n_sel, self.n2 + 1, 3)
        dirs = unit(zs)
        dirs = torch.where((dirs * n[:, None]).sum(-1, keepdim=True) < 0,
                           -dirs, dirs)
        vd_sel, vd_rand = b["viewdirs"][rs], -dirs[:, -1]
        d2 = dirs[:, :-1].reshape(-1, 3)
        rep = lambda x: x.repeat_interleave(self.n2, 0)

        # incoming radiance along the secondary rays
        o2 = rep(q.detach())
        sec = march(g, blocks, p["sdf"], o2, d2, s_val, thres, self.near2,
                    max(1, SECONDARY_CHUNK // g.n_samples))
        inc = {hd: torch.zeros((d2.shape[0], 3), device=v.device).index_add(
            0, sec["ray"], sec["w"][:, None] * v) for hd, v in zip(
            ("off", "emo"), self.radiance_at(p, sec["pts"], d2[sec["ray"]],
                                             sec["sdf"]))}
        env = envmap(p["envmap"], d2) * sec["last"][:, None]

        out = {"rgb": self.per_ray(mk, N, rgb),
               "lin": self.per_ray(mk, N, lin), "last": mk["last"],
               "nsm": nsm, "n_head": int(ray.numel())}
        pair = {"off": [], "emo": [], "off_hat": [], "emo_hat": []}
        for view in (vd_sel, vd_rand):
            for hd, v in zip(("off", "emo"), self.radiance_at(
                    p, q, view, mk["sdf"][order])):
                pair[hd].append(v)
            R = disney(rep(basecolor), rep(rough), rep(metal), rep(n), d2,
                       -rep(view))
            mean = lambda x: x.reshape(n_sel, self.n2, 3).mean(1)
            pair["off_hat"].append(mean((inc["off"] + env) * R))
            pair["emo_hat"].append(emit + mean(inc["emo"] * R))
        out.update({k: torch.cat(v, 0) for k, v in pair.items()})
        return out


# ------------------------------------------------------ loss and the step


def train_steps(config: dict, weights: dict, batches: List[dict], device,
                precision: str = "f32") -> dict:
    """The LTS stage's train steps from the configuration's ``first_step``
    on, from ``weights`` on ``batches`` (one each; each carries the run's
    seed, the key of its draws with the step, as ``draw_seed``). Returns
    each step's ``(mse, lin_mse, off_mse, emo_mse)``, the first step's
    gradient per leaf as Adam takes it, and the parameters after the steps
    (on ``device``)."""
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
    b1, b2, adam_eps = 0.9, 0.99, 1e-8
    white_bg = 1.0 if cfg["data"]["white_bg"] else 0.0
    out = {"losses": [], "grads": None, "n_head": []}
    for j, batch in enumerate(batches):
        i = first_step + j
        seed = int(batch["draw_seed"])
        b = {k: torch.as_tensor(v).to(device) for k, v in batch.items()
             if k != "draw_seed"}
        named = dict(leaves(p))
        for t in named.values():
            t.requires_grad_(True)
        res = model.forward_training(p, b, s_val, key_state(seed, i),
                                     float(tr["normal_eps"]))
        wbg = res["last"][:, None] * white_bg
        srgb = torch.clamp(res["rgb"] + wbg, 0.0, 1.0)
        lin = torch.clamp(res["lin"] + wbg, min=0.0)
        mse = ((srgb - b["rgbs"]) ** 2).mean()
        tone = torch.where(b["rgbs"] >= 1, torch.clamp(lin, max=1.0), lin)
        lin_mse = ((F.gamma(tone) - b["rgbs"]) ** 2).mean()
        off_mse = ((res["off"] - res["off_hat"]) ** 2).mean()
        emo_mse = ((res["emo"] - res["emo_hat"]) ** 2).mean()
        pout = torch.clamp(res["last"][-1], 1e-6, 1 - 1e-6)
        ent = -(pout * torch.log(pout) + (1 - pout) * torch.log(1 - pout))
        loss = (mse + float(tr["weight_linear"]) * lin_mse
                + float(tr["weight_lts"]) * (off_mse + emo_mse)
                + float(tr["weight_entropy_last"]) * ent
                + float(tr["weight_normal_smooth"]) * res["nsm"])
        tv_on = (tr["tv_from"] < i < tr["tv_end"]) and i % tr["tv_every"] == 0
        if tv_on:
            loss = loss + F.smooth_grad_tv(geo, p["sdf"], nonempty,
                                           float(tr["tvs"]["smooth_grad"]))
        names = list(named)
        grads = torch.autograd.grad(loss, [named[n] for n in names],
                                    allow_unused=True)
        g = {n: (torch.zeros_like(named[n]) if x is None else x)
             for n, x in zip(names, grads)}
        if tv_on:
            w = (float(tr["weight_tv_density"]) * float(tr["tvs"]["sdf"])
                 / b["rays_o"].shape[0] * max(geo.world_size) / 128.0)
            tvg = F.sdf_tv_grad(p["sdf"].detach(), w)
            if i >= int(tr["tv_dense_before"]):
                tvg = torch.where(g["sdf"] == 0, torch.zeros_like(tvg), tvg)
            g["sdf"] = g["sdf"] + tvg
        if j == 0:
            out["grads"] = {n: x.detach().clone() for n, x in g.items()}
        out["losses"].append(tuple(float(x.detach()) for x in
                                   (mse, lin_mse, off_mse, emo_mse)))
        out["n_head"].append(res["n_head"])
        with torch.no_grad():
            t = j + 1
            for n in names:
                group = n.split(".")[0]
                lr = lrs[group] * F.lr_scale(cfg, group, i)
                m_, v_ = mom[n]
                m_.mul_(b1).add_(g[n], alpha=1 - b1)
                v_.mul_(b2).addcmul_(g[n], g[n], value=1 - b2)
                denom = torch.sqrt(v_) / math.sqrt(1 - b2 ** t) + adam_eps
                named[n].requires_grad_(False)
                named[n].sub_(lr / (1 - b1 ** t) * m_ / denom)
        del res, loss, grads, g
    out["params"] = dict(leaves(p))
    return out
