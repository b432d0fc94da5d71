"""ESRNeRF: the inverse-rendering model of the LTS and PDRA stages.

Port of ``esrnerf_tpu/models/esrnerf.py``. Adds to :class:`VoxurfF` a BRDF
feature grid and BRDFNet (basecolor, roughness, metallic by a sigmoid
split), EmissionNet (softplus emission), a spherical-Gaussian envmap, and
the light transport segment: surface points spawn ``num_2ndrays``
hemisphere rays whose incoming radiance is volume-rendered by a second
march and composed with the Disney BRDF into the targets ``off_hat`` and
``emo_hat``.

The secondary fan-out (points x directions) is one batched march with its
own budgets, the same ``[N, S] -> K1 -> K2`` pipeline as the primary march.
The reference's random choice of up to ``num_ltspts`` surface points is a
fixed-size selection with a validity mask: the points of the lowest
uniform scores among the march's live rows.

The training forward's randomness is keyed (:mod:`~esrnerf_tpu_torch.ops.
keyed`): a head row's score and its normal and emission perturbations are
a function of the step's :class:`~esrnerf_tpu_torch.ops.keyed.DrawKey`,
the row's ray's place in the step's global batch and its sample's index
along the ray; a chosen point's scattering normals of its own (ray,
sample) and the secondary ray's index. Ties of the score go to the lower
(ray, sample). So the draws do not depend on the march's cell-sorted row
order, a sample that flips out of the live rows changes at most its own
candidacy, and a rank of a data-parallel world (its rays a block of the
global batch at the rank's offset) draws world 1's numbers for its rows.
Explicit draws (:class:`LTSDraws`, :class:`FinetuneDraws`) keep their row
meaning, so a test can feed the JAX package's draws.

On a world of ranks under ``gspmd`` (a forward given the ranks' helpers
``sh``), each rank marches its block of rays and the randomness is world
1's: keyed draws by the global ray index, or explicit draws at world 1's
shapes of which each rank takes the rows of its own head rows' places in
world 1's cell-sorted order (:meth:`~esrnerf_tpu_torch.parallel.mesh.
ShardHelpers.global_positions`). The surface points are world 1's lowest
scores over all ranks (:meth:`~esrnerf_tpu_torch.parallel.mesh.
ShardHelpers.select_lowest`); an explicit scattering draw goes by each
chosen point's place among them. A rank's secondary march is sized for
all ``num_ltspts`` points, as world 1's.

The PDRA stage's pieces: the per-ray emission and expected surface point
probes (:meth:`ESRNeRF.eval_emit`, :meth:`ESRNeRF.eval_esp`) and the
relighting fine-tune's forward (:meth:`ESRNeRF.forward_finetune`).
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from esrnerf_tpu_torch.models import mlp as mlpops
from esrnerf_tpu_torch.models.voxurf_base import _linspace, rebudget_counts
from esrnerf_tpu_torch.models.voxurff import NORMAL_FLIPPER, VoxurfF
from esrnerf_tpu_torch.ops import grid as gridops
from esrnerf_tpu_torch.ops import keyed
from esrnerf_tpu_torch.ops import pbr as pbrops
from esrnerf_tpu_torch.ops.image import hsv_to_rgb, rgb_to_hsv
from esrnerf_tpu_torch.utils import profiling
from esrnerf_tpu_torch.utils.device import small_const

Params = Dict[str, object]


class LTSDraws(NamedTuple):
    """The random draws of one training forward, in the JAX package's
    order (``jax.random.split(rng, 4)``), by head row of the march's
    cell-sorted order (and the chosen points' places)."""

    select: torch.Tensor      # [K2] uniform scores of the point selection
    scatter: torch.Tensor     # [P, n2 + 1, 3] normals of the scattering
    normal_eps: torch.Tensor  # [K2, 3] normals of the normal perturbation
    emit_eps: torch.Tensor    # [K2, 3] normals of the emission perturbation


class FinetuneDraws(NamedTuple):
    """The random draws of one fine-tune forward, in the JAX package's
    order (``jax.random.split(rng)``)."""

    select: torch.Tensor   # [B * ppr] (cached slots) or [K2] uniform scores
    scatter: torch.Tensor  # [P, n2 + 1, 3] normals of the scattering


def _unit_normal(g: torch.Tensor) -> torch.Tensor:
    return g / torch.clamp(torch.linalg.vector_norm(g, dim=-1, keepdim=True),
                           min=1e-12)


class ESRNeRF(VoxurfF):
    def __init__(self, cfg, near, far, xyz_min, xyz_max, mask_cache, s_val,
                 num_voxels, mask_meta=None):
        super().__init__(cfg, near, far, xyz_min, xyz_max, mask_cache, s_val,
                         num_voxels, mask_meta)
        m = cfg.app.model
        if self.neus_alpha != "interp":
            # the reference's LTS and PDRA marches take no gradient grid
            raise ValueError(
                f"app.model.neus_alpha={self.neus_alpha}: the LTS and PDRA "
                "stages (ESRNeRF) march with neus_alpha=interp only")
        self.brdfnet_width = int(m["brdfnet_width"])
        self.brdfnet_depth = int(m["brdfnet_depth"])
        self.env_sg = int(m["env_sg"])
        self.env_activation = str(m["env_activation"])
        self.ray_sampling = str(m["ray_sampling"]).lower()
        self.num_2ndrays = int(m["num_2ndrays"])
        self.num_ltspts = int(m["num_ltspts"])
        self.lts_near = float(m["lts_near"])
        # the secondary march's own budgets per secondary ray: K2 of the
        # heads and K1 of phase 1 (bounce rays keep far fewer samples)
        self.points_per_2ndray = int(m.get("points_budget_per_2ndray", 24))
        self.points_per_2ndray_masked = int(
            m.get("points_budget_masked_per_2ndray",
                  4 * self.points_per_2ndray))

        D = len(self.grad_feat)
        self.brdf_dim0 = (
            (3 + 3 * self.posbase_pe * 2) + self.color_dim + D * 3 + D * 6 + 1
        )
        # PDRA: emission-certain points keep their reflection detached
        self.pdra_mode = False
        # data parallelism: each of this many ranks selects its share of
        # the num_ltspts surface points from its own march
        self.lts_points_divisor = 1

    @property
    def n_lts_points(self) -> int:
        """Surface points a forward selects: ``ceil(num_ltspts /
        lts_points_divisor)``."""
        return -(-self.num_ltspts // self.lts_points_divisor)

    # ------------------------------------------------------------------ init

    def init_params(self, generator: torch.Generator) -> Params:
        """VoxurfF's groups plus a zero BRDF grid, BRDFNet, EmissionNet
        (final biases zero) and the SG envmap, drawn from ``generator``."""
        params = super().init_params(generator)
        X, Y, Z = self.geo.world_size
        dev = self.device
        bd = [self.brdf_dim0] + [self.brdfnet_width] * (self.brdfnet_depth - 1)
        params["brdf"] = torch.zeros((X, Y, Z, self.color_dim), device=dev)
        params["brdfnet"] = mlpops.init_mlp(generator, bd + [5], dev,
                                            zero_final_bias=True)
        params["emitnet"] = mlpops.init_mlp(generator, bd + [3], dev,
                                            zero_final_bias=True)
        env = pbrops.init_sg_params(pbrops.init_sg_draws(generator,
                                                         self.env_sg),
                                    self.env_activation)
        params["envmap"] = {k: v.to(dev) for k, v in env.items()}
        return params

    def training_draws(self, generator: torch.Generator, k2: int) -> LTSDraws:
        """Explicit row-ordered draws for :meth:`forward_training` of a
        primary march of ``k2`` head rows, from ``generator``'s stream on
        its device (the JAX package's draws in shape; the trainers key
        theirs instead)."""
        g, gd = generator, generator.device
        return LTSDraws(
            torch.rand((k2,), generator=g, device=gd),
            pbrops.scattering_draws(g, (self.n_lts_points,),
                                    self.num_2ndrays + 1),
            torch.randn((k2, 3), generator=g, device=gd),
            torch.randn((k2, 3), generator=g, device=gd),
        )

    def finetune_draws(self, generator: torch.Generator,
                       n_rows: int) -> FinetuneDraws:
        """The draws of :meth:`forward_finetune` over ``n_rows`` candidate
        rows (cached slots, or the march's head rows)."""
        g, gd = generator, generator.device
        return FinetuneDraws(
            torch.rand((n_rows,), generator=g, device=gd),
            pbrops.scattering_draws(g, (self.n_lts_points,),
                                    self.num_2ndrays + 1),
        )

    # ----------------------------------------------------------- keyed draws

    # a head row's lanes: its selection score, then the normal and the
    # emission perturbation's three normals each (two lanes a normal); a
    # chosen point's scattering normals from SCATTER_LANE on
    ROW_LANES = 13
    SCATTER_LANE = 16

    def keyed_rows(self, key: keyed.DrawKey, m, sh=None):
        """The keyed draws of the march ``m``'s head rows: ``(draws, h,
        pos)``, ``draws`` an :class:`LTSDraws` without its scattering
        part, ``h`` each row's hash state and ``pos`` its place in the
        global (ray, sample) order, the tie-break of the scores (pad rows
        after every real row, each its own place). A rank's rays are the
        block of the global batch at ``rank x`` its ray count."""
        rank, world = (sh.rank, sh.n) if sh is not None else (0, 1)
        N, K = m.n_rays, m.pad.shape[0]
        ray = m.ray_id + rank * N
        h = keyed.row_hash(key, ray, m.step_id)
        lanes = keyed.lanes(h, self.ROW_LANES)
        eps = keyed.normal(lanes[:, 1:])
        stride = self.geo.n_samples + self.geo.phase1_block  # > any step
        rows = torch.arange(K, dtype=torch.int64, device=h.device)
        pos = torch.where(m.pad, N * world * stride + rank * K + rows,
                          ray * stride + m.step_id)
        return (LTSDraws(keyed.uniform(lanes[:, 0]), None, eps[:, :3],
                         eps[:, 3:]), h, pos)

    def keyed_scatter(self, h: torch.Tensor) -> Optional[torch.Tensor]:
        """``[P, n2 + 1, 3]`` scattering normals of chosen points of hash
        states ``h [P]``; None with Fibonacci sampling."""
        if self.ray_sampling in ("fib", "fibo", "fibonacci"):
            return None
        n = self.num_2ndrays + 1
        z = keyed.normal(keyed.lanes(h, 6 * n, self.SCATTER_LANE))
        return z.reshape(h.shape[0], n, 3)

    @staticmethod
    def select_keyed(scores: torch.Tensor, pos: torch.Tensor,
                     pad: torch.Tensor, P: int):
        """The P lowest keyed ``scores`` (24-bit uniforms) among the
        non-``pad`` rows, ties to the lower global place ``pos``: the
        chosen rows ascending (so pads, chosen only where fewer than P
        rows are real, stay at the tail) and whether each is real."""
        bits = (scores * float(1 << 24)).to(torch.int64)
        rows = torch.arange(pos.shape[0], dtype=torch.int64,
                            device=pos.device)
        order = torch.where(pad, (1 << 62) + rows, (bits << 36) + pos)
        sel, _ = torch.sort(torch.argsort(order)[:P])
        return sel, ~pad.index_select(0, sel)

    # --------------------------------------------------------------- helpers

    def scattering(self, draws: Optional[torch.Tensor], normal: torch.Tensor,
                   number: int) -> torch.Tensor:
        """``[..., number, 3]`` hemisphere directions around ``normal``:
        Fibonacci with ``ray_sampling: fib``, else from the normal
        ``draws``."""
        if self.ray_sampling in ("fib", "fibo", "fibonacci"):
            return pbrops.diffuse_scattering_fib(normal, number)
        return pbrops.diffuse_scattering(draws, normal)

    def envmap_eval(self, params: Params, dirs: torch.Tensor) -> torch.Tensor:
        env = params["envmap"]
        return pbrops.sg_envmap(env["mus"], env["lambdas"], env["lobes"], dirs,
                                activation=pbrops.ACTIVATIONS[
                                    self.env_activation])

    def render_envmap(self, params: Params, H: int, W: int) -> torch.Tensor:
        """Equirectangular ``[H, W, 3]`` image of the envmap."""
        dev = self.device
        phi, theta = torch.meshgrid(_linspace(0.0, np.pi, H, dev),
                                    _linspace(np.pi, -np.pi, W, dev),
                                    indexing="ij")
        dirs = torch.stack(
            [torch.cos(theta) * torch.sin(phi),
             torch.sin(theta) * torch.sin(phi), torch.cos(phi)], dim=-1,
        ).reshape(-1, 3)
        return self.envmap_eval(params, dirs).reshape(H, W, 3)

    def sample_sdf_expgrad(self, sdf_grid: torch.Tensor, pts: torch.Tensor):
        """SDF and its spatial gradient at ``pts`` from the same 8 corners,
        both differentiable w.r.t. the grid."""
        return gridops.grid_sample_3d_coordgrad(
            sdf_grid, pts, self.geo.xyz_min_t, self.geo.xyz_max_t)

    def _brdf_feat(self, params, pts, sdf, n_valid=None, taps=None):
        feat6, normals = taps or self._sdf_taps(params, pts, n_valid)
        return torch.cat([self._xyz_emb_full(pts), sdf[:, None], feat6,
                          normals], -1)

    def _brdf_heads(self, params, pts, brdf_feat, grid_vals=None,
                    emit_grid_key: str = "emo_color"):
        """BRDFNet (sigmoid, split 3/1/1) and EmissionNet (softplus).
        ``grid_vals``: the ``(brdf, emission grid)`` samples of the march
        points from the fused gather; else the BRDF grid and the emission
        grid ``emit_grid_key`` (the live emo grid, or the fine-tune's frozen
        ``emit_color`` snapshot) are read at ``pts`` (any order) by the
        plain sampler."""
        if grid_vals is not None:
            brdf_val, emit_val = grid_vals
        else:
            brdf_val = self.geo.sample_grid(params["brdf"], pts)
            emit_val = self.geo.sample_grid(params[emit_grid_key], pts)
        bx = torch.cat([brdf_val, brdf_feat], -1)
        brdf_out = torch.sigmoid(mlpops.apply_mlp(
            params["brdfnet"], bx, compute_dtype=self.mlp_dtype))
        basecolor, roughness, metallic = (
            brdf_out[:, :3], brdf_out[:, 3:4], brdf_out[:, 4:5])
        ex = torch.cat([emit_val, brdf_feat], -1)
        emit = F.softplus(mlpops.apply_mlp(
            params["emitnet"], ex, compute_dtype=self.mlp_dtype))
        return basecolor, roughness, metallic, emit

    # ------------------------------------------------------- secondary march

    def _secondary_radiance(self, params: Params, rays_o, dirs, s_val,
                            heads=("off", "emo"), budget_rays=None):
        """Incoming radiance along secondary rays: a march from
        ``lts_near`` with the secondary budgets (for ``budget_rays`` rays;
        default, these), the radiance ``heads`` at its points (one fused
        gather of their color grids) and the per-ray sums. Returns
        ``({head: [Nsec, 3]}, alphainv_last [Nsec], sec)`` with ``sec``
        this march's ``(counts, overflow, k1_frac, k2_frac)``
        (:func:`~esrnerf_tpu_torch.models.voxurf_base.march_fractions`)."""
        geo = self.geo
        Nsec = rays_o.shape[0]
        nb = Nsec if budget_rays is None else budget_rays
        with profiling.span("lts/march_2nd"):
            m = geo.march(
                params["sdf"], rays_o, dirs, dirs, s_val, self.fastcolor_thres,
                self.neus_alpha, style="fine",
                k_budget=nb * self.points_per_2ndray,
                k1_budget=nb * self.points_per_2ndray_masked,
                near_override=self.lts_near,
            )
        rid = torch.clamp(m.ray_id, max=Nsec - 1)
        feat = self._features(params, m.pts, dirs.index_select(0, rid), m.sdf,
                              n_valid=m.n_valid)
        gvs = geo.sample_grids_sorted(
            tuple(params[f"{h}_color"] for h in heads), m.pts, m.n_valid)
        out = {}
        for h, gv in zip(heads, gvs):
            out[h] = geo.segment_to_rays(m, self._radiance(params, h, feat,
                                                           gv))
        return out, m.alphainv_last, (m.counts, m.overflow, m.k1_frac,
                                      m.k2_frac)

    def light_transport_segment(
        self, params: Params, scatter_draws, pts, viewdirs, normal, sdf,
        basecolor, roughness, metallic, emission, uncert, valid, s_val,
        budget_pts: Optional[int] = None,
    ) -> Dict[str, torch.Tensor]:
        """Training-time LTS on the P selected surface points (``valid``
        masks slots with no real sample). Returns off/emo and their
        reconstructions, each ``[2P, 3]``: the actual view direction's
        block, then the random view direction's; and the secondary march's
        counts and fractions (``sec``, :meth:`_secondary_radiance`'s; its
        budgets those of ``budget_pts`` points, default P)."""
        geo = self.geo
        n_valid_sel = valid.sum()
        P = pts.shape[0]
        n2 = self.num_2ndrays

        dirs_all = self.scattering(scatter_draws, normal, n2 + 1)
        viewdirs_rand = -dirs_all[:, -1]
        dirs = dirs_all[:, :-1]  # [P, n2, 3]

        # surface radiance for both outgoing directions (targets off/emo)
        feat6, normals6 = self._sdf_taps(params, pts, n_valid_sel)
        vd2 = torch.cat([viewdirs, viewdirs_rand], 0)  # [2P, 3]
        rgb_feat = torch.cat(
            [self._xyz_emb_full(pts).repeat(2, 1), self._view_emb(vd2),
             sdf[:, None].repeat(2, 1), feat6.repeat(2, 1),
             normals6.repeat(2, 1)], -1)
        pts2 = pts.repeat(2, 1)

        def head(h):
            x = torch.cat([geo.sample_grid(params[f"{h}_color"], pts2),
                           rgb_feat], -1)
            return F.softplus(mlpops.apply_mlp(
                params[f"{h}_rgbnet"], x, compute_dtype=self.mlp_dtype))

        off = head("off")  # [2P, 3]
        emo = head("emo")

        # BRDF response of every (point, direction) for both outgoing dirs
        def flat(x, d=3):
            return x[:, None].expand(P, n2, d).reshape(P * n2, d)

        sec_d = dirs.reshape(P * n2, 3)
        R = pbrops.disney_reflection(
            flat(basecolor).repeat(2, 1), flat(roughness, 1).repeat(2, 1),
            flat(metallic, 1).repeat(2, 1), flat(normal).repeat(2, 1),
            sec_d.repeat(2, 1),
            torch.cat([-flat(viewdirs), -flat(viewdirs_rand)], 0),
        )  # [2 P n2, 3]

        # incoming radiance along the secondary rays
        inc, alphainv_last, sec = self._secondary_radiance(
            params, flat(pts), sec_d, s_val,
            budget_rays=None if budget_pts is None else budget_pts * n2)
        env = self.envmap_eval(params, sec_d) * alphainv_last[:, None]

        def mean_dirs(x2):  # [2 P n2, 3] -> [2P, 3]
            return x2.reshape(2 * P, n2, 3).mean(-2)

        off_hat = mean_dirs((inc["off"] + env).repeat(2, 1) * R)
        reflect = mean_dirs(inc["emo"].repeat(2, 1) * R)

        emit2 = emission.repeat(2, 1)
        if self.pdra_mode:
            um2 = uncert.repeat(2)[:, None]
            emo_hat = torch.where(um2, emit2 + reflect.detach(), reflect)
        else:
            emo_hat = emit2 + reflect
        return {"off": off, "emo": emo, "off_hat": off_hat,
                "emo_hat": emo_hat, "valid": valid.repeat(2),
                "sec": sec}

    @staticmethod
    def _select_lts_points(scores: torch.Tensor, march, P: int):
        """The P lowest uniform ``scores`` among the march's non-pad rows
        (pads score 2; ties to the lower index, as ``top_k``), indices
        sorted ascending so the selection stays cell-sorted."""
        scores = torch.where(march.pad, torch.full_like(scores, 2.0), scores)
        sel = torch.argsort(scores, stable=True)[:P]
        sel, _ = torch.sort(sel)
        return sel, ~march.pad.index_select(0, sel)

    def _select_global(self, scores, pad, pos, sh):
        """World 1's choice of the surface points, made over the ranks'
        rows (``gspmd``): the ``n_lts_points`` lowest uniform ``scores``
        (``pad`` rows score 2), ties to the lower world-1 position ``pos``.
        Returns ``(rows, slots, valid, chosen)``: the rank's chosen rows
        ascending in position (so its real rows come first), each one's
        place among all the chosen rows (its scattering draw), which are
        real, and whether any row was chosen. A rank none of whose rows is
        chosen keeps one masked row, its last, so that its LTS runs on one
        slot that no loss reads (and whose secondary samples
        :meth:`_world_counts` leaves out)."""
        scores = torch.where(pad, torch.full_like(scores, 2.0), scores)
        rows, slots = sh.select_lowest(scores, pos, self.n_lts_points)
        if rows.numel() == 0:
            rows = torch.full((1,), pad.numel() - 1, dtype=torch.int64,
                              device=pad.device)
            slots = torch.zeros_like(rows)
            return rows, slots, torch.zeros(1, dtype=torch.bool,
                                            device=pad.device), False
        return rows, slots, ~pad.index_select(0, rows), True

    def _world_counts(self, counts, sh, chosen: bool = True):
        """A secondary march's counts as a rank reports them: under
        ``gspmd`` each rank marches its own points into a buffer sized for
        world 1's, so the budgets in its counts are world 1's, a ``1 / n``
        share each (their sum over the ranks is world 1's), and the global
        fractions are world 1's; a rank with no ``chosen`` point (its one
        masked slot) reports no samples."""
        if sh is None or not sh.global_rows:
            return counts
        n_sec = self.n_lts_points * self.num_2ndrays
        K1, K2, _ = self.geo.march_budgets(
            n_sec, n_sec * self.points_per_2ndray,
            n_sec * self.points_per_2ndray_masked)
        return rebudget_counts(counts, K1 / sh.n, K2 / sh.n, chosen)

    # -------------------------------------------------------------- training

    def forward_training(
        self, params: Params, rays_o, rays_d, viewdirs, em_modes, uncert_masks,
        s_val, normal_eps, emit_eps, draws: Optional[LTSDraws] = None,
        generator: Optional[torch.Generator] = None, sh=None,
        key: Optional[keyed.DrawKey] = None,
    ) -> Dict[str, torch.Tensor]:
        """The LTS training forward. The randomness: explicit ``draws``
        by row, else draws keyed by ``key`` (or by the key that
        ``generator`` names) and each row's ray and sample (the module's
        docstring); the draw work runs in the range ``lts/draws`` and
        counts ``lts.draws_given`` or ``lts.draws_keyed``. The phases run
        inside the ``lts/{march,features,heads,brdf,lts,march_2nd}``
        ranges; the march, the features, the heads, the BRDF heads and the
        light transport segment mark their outputs for the profiled
        backward's ranges ``lts/bwd_{march,features,heads,brdf,segment}``
        (:func:`~esrnerf_tpu_torch.utils.profiling.bwd_mark`). With the
        ranks' helpers ``sh`` under ``gspmd`` the draws are world 1's (the
        module's docstring). ``etc/counts`` and ``etc/counts_2nd`` are both
        marches' counts, which a data-parallel step folds over the
        ranks."""
        geo = self.geo
        glob = sh is not None and sh.global_rows
        with profiling.span("lts/march"):
            sdf = profiling.bwd_mark(None, params["sdf"])
            m = geo.march(
                sdf, rays_o, rays_d, viewdirs, s_val,
                self.fastcolor_thres, self.neus_alpha, style="fine",
            )
            w, a_last, m_sdf = profiling.bwd_mark(
                "march", m.weights, m.alphainv_last, m.sdf)
            m = m._replace(weights=w, alphainv_last=a_last, sdf=m_sdf)
        with profiling.span("lts/draws"):
            h_rows = None
            if draws is not None:
                profiling.count("lts.draws_given")
                if glob:  # the draws of this rank's rows, by world-1 place
                    pos = sh.global_positions(m.key)
                    draws = LTSDraws(*(d if i == 1 else d.index_select(0, pos)
                                       for i, d in enumerate(draws)))
            else:
                profiling.count("lts.draws_keyed")
                if key is None:  # a generator names its seed's key; its
                    # stream is not drawn from
                    key = keyed.DrawKey(generator.initial_seed(), 0)
                draws, h_rows, pos = self.keyed_rows(key, m, sh)
        rid = torch.clamp(m.ray_id, max=m.n_rays - 1)
        with profiling.span("lts/features"):
            _, exp_grad = self.sample_sdf_expgrad(params["sdf"], m.pts)
            taps = self._sdf_taps(params, m.pts, m.n_valid)
            feat = self._features(params, m.pts, viewdirs.index_select(0, rid),
                                  m.sdf, taps=taps)
            feat, exp_grad, *taps = profiling.bwd_mark(
                "features", feat, exp_grad, *taps)
        on_mask = ((em_modes.index_select(0, rid) == 1) & ~m.pad)[:, None]

        with profiling.span("lts/heads"):
            # the four color-grid reads at the march points in one gather
            off_gv, emo_gv, brdf_gv = geo.sample_grids_sorted(
                (params["off_color"], params["emo_color"], params["brdf"]),
                m.pts, m.n_valid)
            off = self._radiance(params, "off", feat, off_gv)
            emo = self._radiance(params, "emo", feat, emo_gv)
            # on rays: emo + off, off not detached (unlike VoxurfF)
            lin_rgb = torch.where(on_mask, emo + off, off)
            rgb = self.apply_tonemapper(params, lin_rgb)
            rgb_m, lin_m = profiling.bwd_mark(
                "heads", geo.segment_to_rays(m, rgb),
                geo.segment_to_rays(m, lin_rgb))

        with profiling.span("lts/brdf"):
            brdf_feat = self._brdf_feat(params, m.pts, m.sdf, taps=taps)
            basecolor, roughness, metallic, emit = profiling.bwd_mark(
                "brdf", *self._brdf_heads(params, m.pts, brdf_feat,
                                          grid_vals=(brdf_gv, emo_gv)))
            emit_m = geo.segment_to_rays(m, emit)
        normal = _unit_normal(exp_grad).detach()

        with profiling.span("lts/lts"):
            chosen = True
            if glob:
                sel, slots, lts_valid, chosen = self._select_global(
                    draws.select, m.pad, pos, sh)
            elif h_rows is not None:
                sel, lts_valid = self.select_keyed(draws.select, pos, m.pad,
                                                   self.n_lts_points)
            else:
                sel, lts_valid = self._select_lts_points(draws.select, m,
                                                         self.n_lts_points)
            with profiling.span("lts/draws"):
                if h_rows is not None:
                    scatter = self.keyed_scatter(h_rows.index_select(0, sel))
                elif glob:
                    scatter = draws.scatter.index_select(0, slots)
                else:
                    scatter = draws.scatter
            rs = rid.index_select(0, sel)
            take = lambda x: x.index_select(0, sel)
            lts = self.light_transport_segment(
                params, scatter, take(m.pts),
                viewdirs.index_select(0, rs), take(normal), take(m.sdf),
                take(basecolor), take(roughness), take(metallic), take(emit),
                uncert_masks.index_select(0, rs), lts_valid, s_val,
                budget_pts=self.n_lts_points if glob else None,
            )
            marked = ("off", "emo", "off_hat", "emo_hat")
            lts.update(zip(marked, profiling.bwd_mark(
                "segment", *(lts[k] for k in marked))))

        with profiling.span("lts/brdf"):
            # eps-perturbed re-evaluations for the smoothness terms
            _, exp_grad_eps = self.sample_sdf_expgrad(
                params["sdf"], m.pts + draws.normal_eps * normal_eps)
            exp_grad_eps = profiling.bwd_mark("brdf", exp_grad_eps)
            pts_e = m.pts + draws.emit_eps * emit_eps
            sdf_e = geo.sample_grid(params["sdf"], pts_e)[..., 0]
            brdf_feat_e = self._brdf_feat(params, pts_e, sdf_e,
                                          n_valid=m.n_valid)
            basecolor_e, rough_e, metal_e, emit_e = self._brdf_heads(
                params, pts_e, brdf_feat_e)

        sec, sec_ovf, sec_k1, sec_k2 = lts["sec"]
        return {
            "etc/alphainv_cum": m.alphainv_last,
            "etc/white_bg": m.alphainv_last[..., None],
            "srgb/rgb": rgb_m,
            "lin/rgb": lin_m,
            "lin/pbr/off": lts["off"],
            "lin/pbr/off_hat": lts["off_hat"],
            "lin/pbr/emo": lts["emo"],
            "lin/pbr/emo_hat": lts["emo_hat"],
            "lin/pbr/valid": lts["valid"],
            "etc/emit_marched": emit_m,
            "etc/normal": exp_grad,
            "etc/normal_eps": exp_grad_eps,
            "etc/emit": emit,
            "etc/emit_eps": emit_e,
            "etc/brdf": torch.cat([basecolor, roughness, metallic], -1),
            "etc/brdf_eps": torch.cat([basecolor_e, rough_e, metal_e], -1),
            "etc/point_valid": ~m.pad,
            # the secondary march's overflow trips the same alarm as the
            # primary's; its utilisations stay separate
            "etc/overflow": torch.maximum(m.overflow, sec_ovf),
            "etc/k1_frac": m.k1_frac,
            "etc/k2_frac": m.k2_frac,
            "etc/k1_frac_2nd": sec_k1,
            "etc/k2_frac_2nd": sec_k2,
            "etc/counts": m.counts,
            "etc/counts_2nd": self._world_counts(sec, sh, chosen),
        }

    # ------------------------------------------------------------ evaluation

    @torch.no_grad()
    def forward_evaluate(self, params: Params, rays_o, rays_d, viewdirs,
                         em_mode: int, pos_rt, s_val, render_pbr: bool = False,
                         emit_grid_key: str = "emo_color"
                         ) -> Dict[str, torch.Tensor]:
        """Eval render of one chunk of rays: VoxurfF's images plus the
        emission, basecolor, roughness and metallic maps. With
        ``render_pbr`` the per-point buffers of the LTS decomposition come
        back under ``pbr_points``."""
        geo = self.geo
        m = geo.march(params["sdf"], rays_o, rays_d, viewdirs, s_val,
                      self.fastcolor_thres, self.neus_alpha, style="fine")
        rid = torch.clamp(m.ray_id, max=m.n_rays - 1)
        vd_pt = viewdirs.index_select(0, rid)
        taps = self._sdf_taps(params, m.pts, m.n_valid)
        feat = self._features(params, m.pts, vd_pt, m.sdf, taps=taps)

        fuse_keys = ["off_color", "emo_color", "brdf"]
        if emit_grid_key != "emo_color":
            fuse_keys.append(emit_grid_key)
        gvs = geo.sample_grids_sorted(tuple(params[k] for k in fuse_keys),
                                      m.pts, m.n_valid)
        off_gv, emo_gv, brdf_gv = gvs[:3]
        emit_gv = gvs[3] if emit_grid_key != "emo_color" else emo_gv
        lin_off = self._radiance(params, "off", feat, off_gv)
        lin_emo = self._radiance(params, "emo", feat, emo_gv)
        lin_on = lin_off + lin_emo
        off = self.apply_tonemapper(params, lin_off)
        emo = self.apply_tonemapper(params, lin_emo)
        on = self.apply_tonemapper(params, lin_on)

        brdf_feat = self._brdf_feat(params, m.pts, m.sdf, taps=taps)
        basecolor, roughness, metallic, emit = self._brdf_heads(
            params, m.pts, brdf_feat, grid_vals=(brdf_gv, emit_gv))

        _, grad_xyz = geo.sample_sdf_grad(params["sdf"], m.pts)
        flip = small_const(NORMAL_FLIPPER, torch.float32, grad_xyz.device)
        nrm_vis = ((_unit_normal(grad_xyz) @ pos_rt) * flip + 1.0) / 2.0

        out = {}
        for key, v in [
            ("srgb/off_rgb", off), ("lin/off_rgb", lin_off),
            ("srgb/on_rgb", on), ("lin/on_rgb", lin_on),
            ("srgb/emo_rgb", emo), ("lin/emo_rgb", lin_emo),
            ("lin/emit", emit), ("lin/basecolor", basecolor),
            ("etc/normal", nrm_vis),
        ]:
            out[key] = geo.segment_to_rays(m, v)
        out["lin/roughness"] = geo.segment_to_rays(m, roughness[:, 0])
        out["lin/metallic"] = geo.segment_to_rays(m, metallic[:, 0])

        depth = geo.segment_to_rays(m, m.step_id.to(torch.float32)
                                    * geo.stepdist)
        disp = 1.0 / (depth + m.alphainv_last * geo.far)
        is_off = int(em_mode) == 0
        out.update({
            "etc/depth": depth,
            "etc/disp": disp,
            "etc/white_bg": m.alphainv_last[..., None],
            "srgb/rgb": out["srgb/off_rgb"] if is_off else out["srgb/on_rgb"],
            "lin/rgb": out["lin/off_rgb"] if is_off else out["lin/on_rgb"],
        })
        if render_pbr:
            # per-point buffers of the chunked decomposition; the app loops
            # lts_eval_chunk over them and sums per ray
            _, exp_grad = self.sample_sdf_expgrad(params["sdf"], m.pts)
            out["pbr_points"] = {
                "pts": m.pts, "viewdirs": vd_pt,
                "normal": _unit_normal(exp_grad),
                "basecolor": basecolor, "roughness": roughness,
                "metallic": metallic, "emit": emit, "ray_id": m.ray_id,
                "weights": m.weights, "pad": m.pad,
            }
        out["etc/overflow"] = m.overflow
        return out

    @torch.no_grad()
    def lts_eval_chunk(self, params: Params, draws, pts, viewdirs_pt, normal,
                       basecolor, roughness, metallic, s_val
                       ) -> Dict[str, torch.Tensor]:
        """Per-point environment and emission decomposition of one chunk of
        march points; ``draws [K, n2, 3]`` are the scattering's normals
        (unused with Fibonacci sampling). The caller weights and sums the
        per-point values per ray. ``etc/overflow`` is the secondary
        march's."""
        K = pts.shape[0]
        n2 = self.num_2ndrays
        dirs = self.scattering(draws, normal, n2).reshape(K * n2, 3)

        def flat(x, d=3):
            return x[:, None].expand(K, n2, d).reshape(K * n2, d)

        R = pbrops.disney_reflection(
            flat(basecolor), flat(roughness, 1), flat(metallic, 1),
            flat(normal), dirs, -flat(viewdirs_pt))
        inc, alphainv_last, sec = self._secondary_radiance(
            params, flat(pts), dirs, s_val)
        env = self.envmap_eval(params, dirs) * alphainv_last[:, None]

        def mean_dirs(x):
            return x.reshape(K, n2, 3).mean(-2)

        env_dir = mean_dirs(env * R)
        env_indir = mean_dirs(inc["off"] * R)
        return {
            "lin/env_dir": env_dir,
            "lin/env_indir": env_indir,
            "lin/env_effects": env_dir + env_indir,
            "lin/emit_(in)dir": mean_dirs(inc["emo"] * R),
            "etc/overflow": sec[1],
        }


    # ------------------------------------------------------- emission probes

    @torch.no_grad()
    def eval_emit(self, params: Params, rays_o, rays_d, viewdirs, s_val,
                  emit_grid_key: str = "emo_color"):
        """Per-ray rendered emission: ``(emission [N, 3], overflow [])``.
        The overflow goes back to the regroup, so that a truncated render
        cannot move a ray to the certain pool unseen."""
        geo = self.geo
        m = geo.march(params["sdf"], rays_o, rays_d, viewdirs, s_val,
                      self.fastcolor_thres, self.neus_alpha, style="fine")
        brdf_feat = self._brdf_feat(params, m.pts, m.sdf, n_valid=m.n_valid)
        ex = torch.cat([geo.sample_grid_sorted(params[emit_grid_key], m.pts,
                                               m.n_valid), brdf_feat], -1)
        emit = F.softplus(mlpops.apply_mlp(params["emitnet"], ex,
                                           compute_dtype=self.mlp_dtype))
        return geo.segment_to_rays(m, emit), m.overflow

    @torch.no_grad()
    def eval_esp(self, params: Params, rays_o, rays_d, viewdirs, s_val):
        """Expected surface point per ray: ``(esp [N, 3], overflow [])``."""
        geo = self.geo
        m = geo.march(params["sdf"], rays_o, rays_d, viewdirs, s_val,
                      self.fastcolor_thres, self.neus_alpha, style="fine")
        return geo.segment_to_rays(m, m.pts), m.overflow

    # --------------------------------------------------------------- finetune

    def forward_finetune(
        self, params: Params, frozen: Params, rays_o, rays_d, viewdirs,
        em_modes, em_intensities, em_colors, s_val,
        draws: Optional[FinetuneDraws] = None,
        generator: Optional[torch.Generator] = None,
        ft_pts=None, ft_valid=None, sh=None,
    ) -> Dict[str, torch.Tensor]:
        """The relighting fine-tune's forward. ``params`` holds the
        trainable emo branch (``emo_color``, ``emo_rgbnet``), ``frozen``
        everything else, with the ``emit_color`` snapshot. Only
        ``lin/pbr/emo`` carries gradients; the edited target
        ``lin/pbr/emo_hat`` is built without them.

        ``ft_pts`` / ``ft_valid`` (``[B, ppr, 3]`` / ``[B, ppr]``): each
        ray's surviving samples against the frozen SDF
        (:meth:`VoxurfGeometry.march_ray_slots`); the surface points are
        then drawn from those slots and the step runs no primary march.
        ``draws`` (or, if None, draws from ``generator``) supplies the
        randomness; with the ranks' helpers ``sh`` under ``gspmd`` it is
        world 1's (the module's docstring); ``etc/counts_2nd`` are the
        secondary march's counts. The phases run
        inside the ranges ``relight/{march,select,heads,target}``."""
        geo = self.geo
        full = {**frozen, **params}
        n2 = self.num_2ndrays
        glob = sh is not None and sh.global_rows
        world = sh.n if glob else 1
        chosen = True

        with profiling.span("relight/select"):
            if ft_pts is not None:
                B, ppr = ft_valid.shape
                flat_pts = ft_pts.reshape(B * ppr, 3)
                flat_ok = ft_valid.reshape(B * ppr)
                if draws is None:
                    draws = self.finetune_draws(generator, B * ppr * world)
                if glob:  # the rank's block of world 1's slots
                    pos = torch.arange(B * ppr, device=flat_ok.device) \
                        + sh.rank * B * ppr
                    sel, slots, valid, chosen = self._select_global(
                        draws.select.index_select(0, pos), ~flat_ok, pos, sh)
                    scatter = draws.scatter.index_select(0, slots)
                else:
                    # the lowest scores among the filled slots, ties to the
                    # lower index (top_k's), ascending
                    scores = torch.where(flat_ok, draws.select,
                                         torch.full_like(draws.select, 2.0))
                    sel = torch.argsort(scores,
                                        stable=True)[:self.n_lts_points]
                    sel, _ = torch.sort(sel)
                    valid = flat_ok.index_select(0, sel)
                    scatter = draws.scatter
                pts = flat_pts.index_select(0, sel)
                rid_sel = torch.div(sel, ppr, rounding_mode="floor")
            else:
                with profiling.span("relight/march"):
                    m = geo.march(full["sdf"], rays_o, rays_d, viewdirs,
                                  s_val, self.fastcolor_thres,
                                  self.neus_alpha, style="fine")
                if draws is None:
                    draws = self.finetune_draws(generator,
                                                m.pts.shape[0] * world)
                rid = torch.clamp(m.ray_id, max=m.n_rays - 1)
                if glob:
                    pos = sh.global_positions(m.key)
                    sel, slots, valid, chosen = self._select_global(
                        draws.select.index_select(0, pos), m.pad, pos, sh)
                    scatter = draws.scatter.index_select(0, slots)
                else:
                    sel, valid = self._select_lts_points(draws.select, m,
                                                         self.n_lts_points)
                    scatter = draws.scatter
                pts = m.pts.index_select(0, sel)
                rid_sel = rid.index_select(0, sel)
            P = pts.shape[0]
            vd = viewdirs.index_select(0, rid_sel)
            modes = em_modes.index_select(0, rid_sel)
            intens = em_intensities.index_select(0, rid_sel)
            colors = em_colors.index_select(0, rid_sel)

            sdf, exp_grad = self.sample_sdf_expgrad(full["sdf"], pts)
            sdf, normal = sdf.detach(), _unit_normal(exp_grad).detach()
            dirs_all = self.scattering(scatter, normal, n2 + 1)
            vd_rand = -dirs_all[:, -1]
            dirs = dirs_all[:, :-1]

        with profiling.span("relight/heads"):
            # surface emo radiance, the only branch with gradients. The
            # taps' pad-chunk skip holds only for the march's selection
            # (pads at the tail); cached slots interleave pads, so they
            # pass no n_valid
            taps = self._sdf_taps(full, pts,
                                  valid.sum() if ft_pts is None else None)
            feat6, normals6 = taps
            vd2 = torch.cat([vd, vd_rand], 0)
            rgb_feat = torch.cat(
                [self._xyz_emb_full(pts).repeat(2, 1), self._view_emb(vd2),
                 sdf[:, None].repeat(2, 1), feat6.repeat(2, 1),
                 normals6.repeat(2, 1)], -1)
            ex = torch.cat([geo.sample_grid(full["emo_color"],
                                            pts.repeat(2, 1)), rgb_feat], -1)
            emo = F.softplus(mlpops.apply_mlp(
                full["emo_rgbnet"], ex, compute_dtype=self.mlp_dtype))

        with torch.no_grad(), profiling.span("relight/target"):
            # the edited target. The taps equal those of the features but
            # for an all-invalid selection, whose rows no loss reads
            brdf_feat = self._brdf_feat(full, pts, sdf, taps=taps)
            basecolor, roughness, metallic, emit = self._brdf_heads(
                full, pts, brdf_feat, emit_grid_key="emit_color")

            def flat(x, d=3):
                return x[:, None].expand(P, n2, d).reshape(P * n2, d)

            sec_d = dirs.reshape(P * n2, 3)
            R = pbrops.disney_reflection(
                flat(basecolor).repeat(2, 1), flat(roughness, 1).repeat(2, 1),
                flat(metallic, 1).repeat(2, 1), flat(normal).repeat(2, 1),
                sec_d.repeat(2, 1),
                torch.cat([-flat(vd), -flat(vd_rand)], 0),
            )
            inc, _, (sec_counts, sec_ovf, _, _) = self._secondary_radiance(
                full, flat(pts), sec_d, s_val, heads=("emo",),
                budget_rays=self.n_lts_points * n2 if glob else None)

            # the light edits: off, intensity, colour (hue and saturation)
            off_m = (modes == 0)[:, None]
            i_m = ((modes == 2) | (modes == 4))[:, None]
            c_m = ((modes == 3) | (modes == 4))[:, None]
            emit = torch.where(off_m, torch.zeros_like(emit), emit)
            emit = torch.where(i_m, emit * intens[:, None], emit)
            hsv = rgb_to_hsv(emit)
            hsv_edit = torch.cat([colors[..., :2], hsv[..., 2:]], -1)
            emit = torch.where(c_m, hsv_to_rgb(hsv_edit), emit)

            reflect = (inc["emo"].repeat(2, 1) * R).reshape(
                2 * P, n2, 3).mean(-2)
            emo_hat = emit.repeat(2, 1) + reflect

        return {
            "lin/pbr/emo": emo,
            "lin/pbr/emo_hat": emo_hat,
            "lin/pbr/valid": valid.repeat(2),
            "etc/overflow": sec_ovf,
            "etc/counts_2nd": self._world_counts(sec_counts, sh, chosen),
        }
