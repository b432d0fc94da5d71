"""Physically based rendering functions: BRDFs, hemisphere scattering,
Fibonacci sphere sampling and the spherical-Gaussian envmap.

Port of ``esrnerf_tpu/ops/pbr.py`` with the same formulas. Randomness is a
separate step: :func:`scattering_draws` and :func:`init_sg_draws` draw from
an explicit ``torch.Generator``, and :func:`diffuse_scattering` and
:func:`init_sg_params` are deterministic functions of the draws, so a test
can feed both packages the same numbers.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

# envmap activations by config name (``app.model.env_activation``)
ACTIVATIONS = {
    "softplus": F.softplus, "relu": torch.relu, "abs": torch.abs,
    "exp": torch.exp, "sigmoid": torch.sigmoid,
}


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a * b).sum(-1, keepdim=True)


def normalize(v: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return v / torch.clamp(torch.linalg.vector_norm(v, dim=-1, keepdim=True),
                           min=eps)


def scattering_draws(generator: torch.Generator, lead_shape,
                     number: int) -> torch.Tensor:
    """Standard normal draws ``[*lead_shape, number, 3]`` for
    :func:`diffuse_scattering`, on ``generator``'s device."""
    return torch.randn((*lead_shape, number, 3), generator=generator,
                       device=generator.device)


def diffuse_scattering(draws: torch.Tensor, normal: torch.Tensor
                       ) -> torch.Tensor:
    """Uniform hemisphere directions around ``normal [..., 3]`` from
    Gaussian sphere draws ``[..., number, 3]``, sign-flipped into the
    normal's hemisphere. Not differentiated."""
    with torch.no_grad():
        dirs = normalize(draws.to(normal.dtype))
        inward = (dirs * normal[..., None, :]).sum(-1, keepdim=True) < 0
        return torch.where(inward, -dirs, dirs)


def fibonacci_hemisphere(nb_samples: int, up: bool = True) -> np.ndarray:
    """Deterministic Fibonacci-spiral hemisphere directions."""
    n = 2 * nb_samples
    rn = np.arange(nb_samples, n) if up else np.arange(nb_samples)
    shift = 1.0
    ga = math.pi * (3.0 - math.sqrt(5.0))
    offset = 1.0 / nb_samples
    phi = ga * ((rn + shift) % n)
    cos_theta = ((rn + 0.5) * offset) - 1.0
    sin_theta = np.sqrt(1.0 - cos_theta * cos_theta)
    return np.stack(
        [np.cos(phi) * sin_theta, np.sin(phi) * sin_theta, cos_theta], axis=-1
    ).astype(np.float32)


def fibonacci_sphere(nb_samples: int) -> np.ndarray:
    """Deterministic Fibonacci-spiral sphere directions."""
    rn = np.arange(nb_samples)
    shift = 1.0
    ga = math.pi * (3.0 - math.sqrt(5.0))
    offset = 2.0 / nb_samples
    phi = ga * ((rn + shift) % nb_samples)
    cos_theta = ((rn + 0.5) * offset) - 1.0
    sin_theta = np.sqrt(1.0 - cos_theta * cos_theta)
    return np.stack(
        [np.cos(phi) * sin_theta, np.sin(phi) * sin_theta, cos_theta], axis=-1
    ).astype(np.float32)


def diffuse_scattering_fib(normal: torch.Tensor, number: int) -> torch.Tensor:
    """Fibonacci hemisphere directions, sign-flipped into the normal's
    hemisphere: ``[..., number, 3]``."""
    with torch.no_grad():
        base = torch.as_tensor(fibonacci_hemisphere(number),
                               device=normal.device)
        dirs = base.expand(*normal.shape[:-1], number, 3)
        inward = (dirs * normal[..., None, :]).sum(-1, keepdim=True) < 0
        return torch.where(inward, -dirs, dirs)


def disney_reflection(albedo, roughness, metallic, normal, win, wout):
    """Disney-style BRDF response, the one the models use:
    ``(diffuse + specular) * (n . wi) * 2 pi`` with an SG-normalised D,
    Schlick F and Schlick-GGX V."""
    EPS = 1e-7

    h = normalize(win + wout)
    noh = torch.clamp(dot(normal, h), min=0.0)
    ooh = torch.clamp(dot(wout, h), min=0.0)
    ion = torch.clamp(dot(win, normal), min=0.0)
    oon = torch.clamp(dot(wout, normal), min=0.0)

    fd = (1.0 - metallic) * albedo / math.pi

    r2 = torch.clamp(roughness * roughness, min=EPS)
    D = (1.0 / (r2 * math.pi)) * torch.exp((2.0 / r2) * (noh - 1.0))

    F0 = 0.04 * (1.0 - metallic) + albedo * metallic
    Fr = F0 + (1.0 - F0) * ((1.0 - ooh) ** 5)

    def v_schlick_ggx(cos):
        k = ((1.0 + roughness) ** 2) / 8.0
        return 0.5 / torch.clamp(cos * (1.0 - k) + k, min=EPS)

    V = v_schlick_ggx(ion) * v_schlick_ggx(oon)
    fs = D * Fr * V
    return (fd + fs) * ion * math.pi * 2.0


def micro_reflection(albedo, roughness, normal, win, wout):
    """Microfacet BRDF variant (kept for config parity; no model uses
    it)."""
    F0 = 0.04
    h = normalize(win + wout)
    k = roughness**4 / 2.0
    rho = roughness**2

    NoO = dot(normal, wout)
    NoI = dot(normal, win)
    NoH = dot(normal, h)
    HoI = dot(h, win)

    D = rho**2 / (math.pi * (NoH**2 * (rho**2 - 1) + 1) ** 2)
    Fr = F0 + (1 - F0) * (1 - HoI) ** 5
    G = NoI / ((NoO * (1 - k) + k) * (NoI * (1 - k) + k))
    return D * Fr * G / 2 * math.pi + NoI * (1 - Fr) * albedo * 2


def tensoir_reflection(albedo, roughness, normal, win, wout,
                       fresnel: float = 0.04):
    """TensoIR BRDF variant (kept for config parity; no model uses it)."""
    L = normalize(win)
    V = normalize(wout)
    H = normalize((L + V) / 2.0)
    N = normalize(normal)

    NoV = (V * N).sum(-1, keepdim=True)
    N = N * torch.sign(NoV)

    NoL = torch.clamp((N * L).sum(-1, keepdim=True), 1e-6, 1)
    NoV = torch.clamp((N * V).sum(-1, keepdim=True), 1e-6, 1)
    NoH = torch.clamp((N * H).sum(-1, keepdim=True), 1e-6, 1)
    VoH = torch.clamp((V * H).sum(-1, keepdim=True), 1e-6, 1)

    alpha = roughness * roughness
    alpha2 = alpha * alpha
    k = (alpha + 2 * roughness + 1.0) / 8.0
    FMi = ((-5.55473) * VoH - 6.98316) * VoH
    frac0 = fresnel + (1 - fresnel) * torch.pow(2.0, FMi)
    frac = frac0 * alpha2
    nom0 = NoH * NoH * (alpha2 - 1) + 1
    nom1 = NoV * (1 - k) + k
    nom2 = NoL * (1 - k) + k
    nom = torch.clamp(4 * math.pi * nom0 * nom0 * nom1 * nom2, 1e-6,
                      4 * math.pi)
    spec = frac / nom
    brdf = albedo / math.pi + spec
    return 2 * math.pi * NoL * brdf


def sg_envmap(mus, lambdas, lobes, dirs, activation=F.softplus):
    """Spherical-Gaussian mixture envmap at unit directions: mus ``[K,3]``,
    lambdas ``[K,1]``, lobes ``[K,3]``; dirs ``[..., 3]`` -> ``[..., 3]``."""
    lobes_n = normalize(lobes)
    lam = torch.abs(lambdas)
    cos = (dirs[..., None, :] * lobes_n).sum(-1, keepdim=True)  # [...,K,1]
    contrib = mus * torch.exp(lam * (cos - 1.0))  # [...,K,3]
    return activation(contrib.sum(-2))


def init_sg_draws(generator: torch.Generator, num_sg: int = 48):
    """The three standard normal draws of :func:`init_sg_params`:
    ``([K,3], [K,1], [K,3])`` on ``generator``'s device."""
    dev = generator.device
    return tuple(torch.randn(s, generator=generator, device=dev)
                 for s in ((num_sg, 3), (num_sg, 1), (num_sg, 3)))


def init_sg_params(draws, activation: str = "softplus"):
    """Energy-normalised SG envmap parameters from the normal draws
    ``(mus, lambdas, lobes)`` of :func:`init_sg_draws`."""
    n_mus, n_lam, n_lobes = draws
    mus = n_mus
    lambdas = 10.0 + torch.abs(n_lam * 20.0)
    lobes = n_lobes

    act = ACTIVATIONS[activation]
    lam = torch.abs(lambdas)
    energy = act(mus) * 2.0 * math.pi / lam * (1.0 - torch.exp(-2.0 * lam))
    normalized_mu = act(mus) / energy.sum(0, keepdim=True) * 2.0 * math.pi \
        * 0.8
    if activation in ("abs", "relu"):
        mus = normalized_mu
    elif activation == "softplus":
        mus = torch.log(torch.expm1(normalized_mu))
    elif activation == "exp":
        mus = torch.log(normalized_mu)
    return {"mus": mus, "lambdas": lambdas, "lobes": lobes}
