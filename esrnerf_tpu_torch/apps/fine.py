"""The fine-stage train step: ``VoxurfF.forward_training`` -> loss ->
backward -> SDF TV gradient -> per-group Adam.

Port of the step body of ``esrnerf_tpu/apps/fine.py::Fine._build_train_step``
for one device (cross-device mean/sum/max become plain mean/identity/max).
The ``Fine`` trainer around it (data, checkpoints, eval, logging) is not
ported yet.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Tuple

import torch
from torch.profiler import record_function

from esrnerf_tpu_torch.ops.image import apply_gamma_curve
from esrnerf_tpu_torch.utils.device import resolve_device


def _leaves(tree, prefix=()) -> List[Tuple[tuple, torch.Tensor]]:
    if isinstance(tree, dict):
        out = []
        for k, v in tree.items():
            out += _leaves(v, prefix + (k,))
        return out
    return [(prefix, tree)]


def _unflatten(paths, values) -> Dict:
    out: Dict = {}
    for path, v in zip(paths, values):
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = v
    return out


def fine_loss(model, params, batch, s_val, tv_flag, smooth_grad_tv, *,
              w_ent: float, w_lin: float, white_bg: float):
    """The fine loss: ``mse + w_lin * lin_mse`` plus the last-ray entropy
    term plus ``tv_flag * density_total_variation``. Returns ``(loss,
    (mse, lin_mse, overflow, k1_frac, k2_frac))``."""
    res = model.forward_training(
        params, batch["rays_o"], batch["rays_d"], batch["viewdirs"],
        batch["em_modes"], s_val,
    )
    wbg = res["etc/white_bg"] * white_bg
    srgb = torch.clamp(res["srgb/rgb"] + wbg, 0.0, 1.0)
    lin = torch.clamp(res["lin/rgb"] + wbg, min=0.0)
    rgbs = batch["rgbs"]
    mse = ((srgb - rgbs) ** 2).mean()

    lin_tone = torch.where(rgbs >= 1, torch.clamp(lin, max=1.0), lin)
    lin_mse = ((apply_gamma_curve(lin_tone) - rgbs) ** 2).mean()
    loss = mse + w_lin * lin_mse

    # the reference's entropy term reads only the batch's last ray
    pout = torch.clamp(res["etc/alphainv_cum"][..., -1], 1e-6, 1 - 1e-6)
    ent = -(pout * torch.log(pout) + (1 - pout) * torch.log(1 - pout)).mean()
    loss = loss + w_ent * ent

    if tv_flag:
        loss = loss + tv_flag * model.density_total_variation(
            params, smooth_grad_tv)
    return loss, (mse, lin_mse, res["etc/overflow"], res["etc/k1_frac"],
                  res["etc/k2_frac"])


def build_fine_train_step(model, opt, cfg, device="cuda") -> Callable:
    """The fine train step for one device.

    Returns ``train_step(params, opt_state, batch, s_val, lr_scales,
    tv_flag, smooth_grad_tv, sdf_tv_w, tv_dense) -> (params, opt_state,
    (mse, lin_mse, overflow, k1_frac, k2_frac))`` with the reference's
    argument order. ``batch`` holds ``rays_o, rays_d, viewdirs, em_modes,
    rgbs`` tensors on the model's device; the scalars are Python numbers
    (``tv_dense`` a bool). Parameters and optimizer state are updated in
    place. The aux values stay on the device (no host sync). The phases
    run inside ``torch.profiler.record_function`` ranges (``fine/loss``,
    ``fine/backward``, ``fine/sdf_tv_grad``, ``fine/adam``; the forward's
    own ``fine/march``, ``fine/features``, ``fine/heads``) so a profile
    attributes device time to them.

    ``device`` must be the model's device; ``"cuda"`` (the default) raises
    without CUDA. TF32 is switched off for matmuls and cuDNN here, so the
    head matmuls run in full f32.
    """
    dev = resolve_device(device)
    if model.device.type != dev.type:
        raise ValueError(f"model lives on {model.device}, step asked for {dev}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    tr = cfg.app["trainer"]
    w_ent = float(tr["weight_entropy_last"])
    w_lin = float(tr["weight_linear"])
    white_bg = float(cfg.data["white_bg"])

    def train_step(params, opt_state, batch, s_val, lr_scales, tv_flag,
                   smooth_grad_tv, sdf_tv_w, tv_dense):
        flat = _leaves(params)
        paths = [p for p, _ in flat]
        leaves = [t.detach().requires_grad_(True) for _, t in flat]
        p_graph = _unflatten(paths, leaves)
        with record_function("fine/loss"):
            loss, aux = fine_loss(model, p_graph, batch, s_val, tv_flag,
                                  smooth_grad_tv, w_ent=w_ent, w_lin=w_lin,
                                  white_bg=white_bg)
        with record_function("fine/backward"):
            gl = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = _unflatten(paths, [torch.zeros_like(t) if g is None else g
                                   for t, g in zip(leaves, gl)])

        # in-place SDF TV as a gradient term (dense, or sparse on the
        # gradient's nonzero pattern)
        if tv_flag:
            with torch.no_grad(), record_function("fine/sdf_tv_grad"):
                tv_g = model.sdf_tv_grad(
                    params["sdf"], sdf_tv_w,
                    sparse_grad=None if tv_dense else grads["sdf"])
                grads["sdf"] = grads["sdf"] + tv_flag * tv_g

        with record_function("fine/adam"):
            params, opt_state = opt.step(params, grads, opt_state,
                                         lr_scales=lr_scales)
        return params, opt_state, tuple(a.detach() for a in aux)

    return train_step
