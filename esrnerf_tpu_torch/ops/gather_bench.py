"""The two gather microbenchmarks' kernels: the per-chunk windowed gather
(K-5) and the piece-sweep gather (K-6).

Port of the Pallas bodies of ``scripts/bench_gather_grid.py`` (``body``,
K-5) and ``scripts/bench_gather_parts.py`` (``body``, K-6). Both read a
table of 128-word tiles, ``tbl [T, 1, 128]`` f32, as one flat array
``tbl_flat`` and write ``[., 24, 2048]`` outputs: 4 offset families ``k``
(stride 37) x 6 taps ``w`` per lane, 16 groups ``g`` x 128 lanes ``j``.
On a CUDA tensor each function launches its kernel (``csrc/gather_bench.cu``);
on a CPU tensor it runs the plain version beside it, vectorised from the
same closed forms.

The TPU bodies build each tap by one-hot MXU matmuls over VMEM pieces and
lane rolls. The port computes exact f32 results by direct indexed loads,
which equals the scripts' ``prec=HIGHEST``; ``prec=DEFAULT`` rounds the TPU
matmul's operands to bf16 and does not carry over. The scripts' ``stage``
flag only moves data between TPU memories and does not change the result,
so it has no counterpart here either.
"""

from __future__ import annotations

import torch

from esrnerf_tpu_torch.ops import kernels

GROUP = 128  # lanes per group (G)
GCAP = 98304  # words of one chunk's or piece's window
NCAP_T = GCAP // GROUP  # tiles of a window (NT = 768)
EXT_T = 2  # extra tiles read past a window
W = 6  # taps per family
K = 4  # offset families, 37 words apart
FAMILY_STRIDE = 37
GROUPS = 16
LANES = GROUPS * GROUP  # 2048 output lanes per chunk / piece
MODES = ("dma", "build", "full")


def _fdiv(a: torch.Tensor, b: int) -> torch.Tensor:
    return torch.div(a, b, rounding_mode="floor")


# --------------------------------------------------------------------- K-5


def grid_taps(idx, w0, gf, gl):
    """K-5's table positions ``pos [NCH, K, W, 16, G]`` (int64) and hit
    mask ``ok [NCH, K, 1, 16, G]``, from the closed form."""
    NCH = w0.shape[0]
    dev = idx.device
    G, NT = GROUP, NCAP_T
    w0l = w0.long()[:, None, None]  # [NCH, 1, 1]
    ck = (torch.arange(K, device=dev) * FAMILY_STRIDE)[None, :, None]
    t0 = torch.clamp(_fdiv(gf.long()[:, None, :] + ck - w0l, G), 0, NT - 1)
    t1 = torch.clamp(_fdiv(gl.long()[:, None, :] + ck - w0l, G), max=NT - 1)
    hi = torch.where(t1 > t0 + 1, G * (t0 + 2 + 2 * _fdiv(t1 - t0, 2)),
                     G * t0 + 2 * G)  # [NCH, K, 16]
    rel = (idx.long().reshape(NCH, 1, GROUPS, G)
           + ck[..., None] - w0l[..., None])  # [NCH, K, 16, G]
    ok = ((rel >= 0) & (rel < GCAP) & (rel >= (G * t0)[..., None])
          & (rel < hi[..., None]))
    b = (_fdiv(w0.long(), G) * G)[:, None, None, None]
    taps = torch.arange(W, device=dev)[None, None, :, None, None]
    return (b + rel)[:, :, None] + taps, ok[:, :, None]


def _gather_grid_plain(tbl_flat, idx, w0, gf, gl):
    pos, ok = grid_taps(idx, w0, gf, gl)
    vals = tbl_flat[torch.clamp(pos, 0, tbl_flat.numel() - 1)]
    out = torch.where(ok, vals, torch.zeros_like(vals))
    return out.reshape(w0.shape[0], K * W, LANES)


def gather_grid(tbl, idx, w0, gf, gl) -> torch.Tensor:
    """K-5: ``out [NCH, 24, 2048]`` from ``tbl [T, 1, 128]`` f32, ``idx
    [NCH*16, 128]``, ``w0 [NCH]``, ``gf, gl [NCH, 16]`` (int32).

    With ``b = (w0[c] // 128) * 128``, ``rel = idx[16c+g, j] + 37k - w0[c]``,
    ``t0 = clip((gf[c,g] + 37k - w0[c]) // 128, 0, 767)``,
    ``t1 = min((gl[c,g] + 37k - w0[c]) // 128, 767)`` and ``hi = 128 (t0 + 2
    + 2 ((t1 - t0) // 2))`` if ``t1 > t0 + 1`` else ``128 t0 + 256``:
    ``out[c, 6k+w, 128g+j] = tbl_flat[b + rel + w]`` where ``0 <= rel <
    GCAP`` and ``128 t0 <= rel < hi``, else 0 (floor division).
    """
    NCH = w0.shape[0]
    if (idx.shape != (NCH * GROUPS, GROUP) or gf.shape != (NCH, GROUPS)
            or gl.shape != (NCH, GROUPS) or tbl.shape[-1] != GROUP):
        raise ValueError("gather_grid: shape mismatch")
    if tbl.is_cuda:
        i32 = lambda t: t.to(torch.int32).contiguous()
        return kernels.gather_grid(tbl.to(torch.float32).contiguous(),
                                   i32(idx), i32(w0), i32(gf), i32(gl))
    return _gather_grid_plain(tbl.reshape(-1).to(torch.float32), idx, w0, gf,
                              gl)


# --------------------------------------------------------------------- K-6


def _gather_parts_plain(tbl_flat, mode: str, npiece: int):
    dev = tbl_flat.device
    G, NT = GROUP, NCAP_T
    out = torch.zeros((K, W, GROUPS, G), dtype=torch.float32, device=dev)
    if mode == "dma":
        return out.reshape(1, K * W, LANES)
    k = torch.arange(K, device=dev)[:, None, None, None]
    w = torch.arange(W, device=dev)[None, :, None, None]
    g = torch.arange(GROUPS, device=dev)[None, None, :, None]
    j = torch.arange(G, device=dev)[None, None, None, :]
    r = 3 * j + FAMILY_STRIDE * k - 5  # [K, 1, 1, G]
    v_rel = (r >= 0) & (r < GCAP)
    zero = torch.zeros((), device=dev)
    for p in range(npiece):
        t0 = (13 * p + 7 * g + k) % NT  # [K, 1, 16, 1]
        base = GCAP * p
        if mode == "full":
            hit = v_rel & (r - G * t0 >= 0) & (r - G * t0 < 2 * G)
            v = tbl_flat[torch.clamp(base + r + w, 0, tbl_flat.numel() - 1)]
            out = out + torch.where(hit, v, zero)
        else:  # build
            x0 = tbl_flat[base + G * t0 + j + w]
            x1 = tbl_flat[base + G * t0 + G + j + w]
            ind = (v_rel & (r - G * t0 == w)).to(torch.float32)
            out = (out + (x0 + x1)) + ind
    return out.reshape(1, K * W, LANES)


def gather_parts(tbl, mode: str, npiece: int = 64) -> torch.Tensor:
    """K-6: ``out [1, 24, 2048]`` after sweeping ``npiece`` pieces of
    ``NT + 2`` tiles of ``tbl [T, 1, 128]`` f32, piece ``p`` starting at word
    ``GCAP p``. With ``r = 3j + 37k - 5`` and ``t0 = (13p + 7g + k) mod NT``:

    - ``full``: ``sum_p [0 <= r < GCAP and 0 <= r - 128 t0 < 256]
      tbl_flat[GCAP p + r + w]``;
    - ``build``: ``sum_p (tbl_flat[GCAP p + 128 t0 + j + w] +
      tbl_flat[GCAP p + 128 t0 + 128 + j + w] + [0 <= r < GCAP and
      r - 128 t0 = w])``, each piece's term added as ``(out + (x0 + x1)) +
      ind`` in piece order;
    - ``dma``: zeros, after the kernel has read every piece's words.

    The scripts' ``when`` mode adds a branch that is never taken and equals
    ``full``.
    """
    if mode == "when":
        mode = "full"
    if mode not in MODES:
        raise ValueError(f"gather_parts: unknown mode '{mode}'")
    need = npiece * GCAP + EXT_T * GROUP
    if tbl.shape[-1] != GROUP or tbl.numel() < need:
        raise ValueError(f"gather_parts: table needs >= {need} words in "
                         f"128-word tiles, got {tuple(tbl.shape)}")
    if tbl.is_cuda:
        t = tbl.to(torch.float32).contiguous()
        if t.data_ptr() % 16:  # a view off a 16-byte boundary: the kernels
            t = t.clone()      # read the table by 16-byte bulk copies
        return kernels.gather_parts(t, mode, npiece)
    return _gather_parts_plain(tbl.reshape(-1).to(torch.float32), mode,
                               npiece)
