"""Build, load, launch and count the port's hand-written CUDA kernels.

Each CUDA source under ``esrnerf_tpu_torch/csrc/`` is compiled by ``nvcc``
for ``sm_90a`` into its own shared library with a plain C interface and
loaded with :mod:`ctypes`; the host-code libraries (the marching-tetrahedra
mesher ``marching.cpp``, the PNG row unfilter ``png_unfilter.cpp`` and the
PIZ Huffman decoder ``piz.cpp``) are compiled by the host C++ compiler the
same way.
Building happens at first use (or through :func:`build`), one compiler
process per source, all started together, into the git-ignored
``esrnerf_tpu_torch/build/``. A library's file name carries a hash of its
sources and flags, so an edited source is never served by a stale library.
Importing this module builds nothing and needs neither ``nvcc`` nor a GPU.

The launch helpers take CUDA tensors only: they run on PyTorch's current
stream, allocate nothing, never synchronise, and raise if the launch was
refused. :data:`launches` counts every launch by kernel name, so a run can
show which kernels the main path went through.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from typing import Dict, Optional, Sequence

import torch

from esrnerf_tpu_torch.models import mlp as mlpops

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")

# library -> source file; each is built into its own .so
SOURCES = {"scan": "scan.cu", "splat": "splat.cu", "gather": "gather.cu",
           "gather_bench": "gather_bench.cu", "heads": "heads.cu"}
# host-code libraries (no CUDA), built by the host C++ compiler
HOST_SOURCES = {"marching": "marching.cpp", "png_unfilter": "png_unfilter.cpp",
                "piz": "piz.cpp"}
_HEADERS = ("common.cuh",)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17")

# kernel name -> launches since the last reset_launches()
launches: Dict[str, int] = {
    "scan_fwd": 0, "scan_bwd": 0, "splat": 0, "gather_weighted": 0,
    "gather_raw": 0, "gather_grid": 0, "gather_parts_dma": 0,
    "gather_parts_build": 0, "gather_parts_full": 0, "eval_heads": 0,
}

_vp, _i, _ll, _f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float
_LL_P = ctypes.POINTER(ctypes.c_longlong)
_I_P = ctypes.POINTER(ctypes.c_int)
_VP_P = ctypes.POINTER(ctypes.c_void_p)
_SIGNATURES = {
    "scan": {
        "esr_scan_fwd": [_vp, _vp, _vp, _vp, _i, _i, _f, _i, _vp],
        "esr_scan_bwd": [_vp, _vp, _vp, _vp, _vp, _i, _i, _f, _i, _vp],
        "esr_scan_config": [_i, _i, _i, _I_P, _I_P],
    },
    "splat": {
        "esr_splat": [_vp, _vp, _LL_P, _i, _i, _i, _ll, _vp, _vp, _vp],
    },
    "gather": {
        "esr_gather_weighted": [_vp, _ll, _i, _vp, _vp, _LL_P, _i, _i, _vp,
                                _vp, _vp],
        "esr_gather_raw": [_vp, _ll, _vp, _LL_P, _i, _i, _vp, _vp, _vp],
    },
    "gather_bench": {
        "esr_gather_grid": [_vp, _ll, _vp, _vp, _vp, _vp, _i, _vp, _vp],
        "esr_gather_parts": [_vp, _ll, _i, _i, _vp, _vp],
    },
    "heads": {
        "esr_eval_heads": [_VP_P, _i, _i, _i, _i, _i, _f, _vp],
    },
}
# host libraries: function -> (argtypes, restype)
_I64, _F_P = ctypes.c_int64, ctypes.POINTER(ctypes.c_float)
_HOST_SIGNATURES = {
    "marching": {
        "mt_extract": ([_F_P, _I64, _I64, _I64, _f], _vp),
        "mt_num_verts": ([_vp], _I64),
        "mt_num_tris": ([_vp], _I64),
        "mt_copy": ([_vp, _F_P, ctypes.POINTER(_I64)], None),
        "mt_free": ([_vp], None),
    },
    "png_unfilter": {
        "esr_png_unfilter": ([_vp, _I64, _I64, _i, _vp], _I64),
    },
    "piz": {
        "piz_huf_decode": ([ctypes.c_char_p, _I64,
                            ctypes.POINTER(ctypes.c_uint16), _I64], _i),
    },
}

_libs: Dict[str, ctypes.CDLL] = {}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    cands = [os.path.join(home, "bin", "nvcc")] if home else []
    cands += [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH); the CUDA "
        "kernels are built from esrnerf_tpu_torch/csrc at first use"
    )


def _cxx() -> str:
    for c in (os.environ.get("CXX"), shutil.which("g++"), shutil.which("c++")):
        if c:
            return c
    raise RuntimeError("no host C++ compiler (g++ or c++) found to build "
                       "the host libraries of esrnerf_tpu_torch/csrc")


def _source(name: str) -> str:
    return SOURCES.get(name) or HOST_SOURCES[name]


def _lib_path(name: str) -> str:
    host = name in HOST_SOURCES
    h = hashlib.sha1(" ".join(CXX_FLAGS if host else NVCC_FLAGS).encode())
    for f in (_source(name), *(() if host else _HEADERS)):
        with open(os.path.join(CSRC, f), "rb") as fh:
            h.update(fh.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:12]}.so")


def build(names: Optional[Sequence[str]] = None) -> Dict[str, str]:
    """Compile the libraries not built yet (all, or ``names``), one compiler
    process per source, all in parallel. Returns ``{name: compiler
    report}`` (for CUDA sources ``-Xptxas -v``: registers, shared memory and
    spills per kernel) for those compiled now. Raises with the compiler's
    output if any build fails."""
    names = list(names) if names is not None else [*SOURCES, *HOST_SOURCES]
    todo = [n for n in names if not os.path.exists(_lib_path(n))]
    if not todo:
        return {}
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    for n in todo:
        out = _lib_path(n)
        tmp = f"{out}.{os.getpid()}.tmp"
        if n in HOST_SOURCES:
            cmd = [_cxx(), *CXX_FLAGS]
        else:
            cmd = [_nvcc(), *NVCC_FLAGS]
        cmd += ["-o", tmp, os.path.join(CSRC, _source(n))]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp, out)
    reports, failed = {}, []
    for n, (p, tmp, out) in procs.items():
        log, _ = p.communicate()
        reports[n] = log
        if p.returncode != 0:
            failed.append(f"--- {_source(n)} (exit {p.returncode})\n{log}")
            if os.path.exists(tmp):
                os.remove(tmp)
        else:
            os.replace(tmp, out)  # atomic: no process loads half a file
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return reports


def lib(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built first if needed."""
    if name not in _libs:
        # first use builds every CUDA library together; a host library alone
        build(list(SOURCES) if name in SOURCES else [name])
        so = ctypes.CDLL(_lib_path(name))
        if name in HOST_SOURCES:
            for fn, (args, res) in _HOST_SIGNATURES[name].items():
                getattr(so, fn).argtypes = args
                getattr(so, fn).restype = res
            _libs[name] = so
            return so
        for fn, args in _SIGNATURES[name].items():
            getattr(so, fn).argtypes = args
            getattr(so, fn).restype = ctypes.c_int
        so.esr_error_string.argtypes = [ctypes.c_int]
        so.esr_error_string.restype = ctypes.c_char_p
        _libs[name] = so
    return _libs[name]


# ---------------------------------------------------------------- launchers


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _offsets(offsets: Sequence[int]):
    return (ctypes.c_longlong * max(1, len(offsets)))(*[int(o) for o in offsets])


def _check(name: str, so: ctypes.CDLL, err: int) -> None:
    if err != 0:
        raise RuntimeError(
            f"CUDA kernel {name} launch failed: "
            f"{so.esr_error_string(err).decode()} ({err})"
        )


def _require(t: torch.Tensor, dtype: torch.dtype, what: str) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of ``dtype``."""
    if not t.is_cuda or t.dtype != dtype or not t.is_contiguous():
        raise ValueError(
            f"{what}: kernel needs a contiguous CUDA {dtype} tensor, got "
            f"{t.dtype} on {t.device} (contiguous={t.is_contiguous()})"
        )


def _nv(n_valid: Optional[torch.Tensor], device) -> Optional[torch.Tensor]:
    if n_valid is None:
        return None
    nv = torch.as_tensor(n_valid, device=device).to(torch.int32).reshape(())
    return nv.contiguous()


def scan_tma_ok(S: int, *tensors: torch.Tensor) -> bool:
    """Whether the scan kernels move these ``[N, S]`` f32 tensors by TMA:
    rows a multiple of 16 bytes (S a multiple of 4) and 16-byte aligned
    bases. Otherwise they take the cp.async route."""
    return S > 0 and S % 4 == 0 and all(t.data_ptr() % 16 == 0
                                        for t in tensors)


def scan_config(S: int, N: int, backward: bool) -> Dict[str, int]:
    """The ring depth and dynamic shared memory per block that K-1 (or K-2,
    ``backward``) takes for N rays of S samples on the current GPU."""
    so = lib("scan")
    stages, smem = ctypes.c_int(), ctypes.c_int()
    _check("scan_config", so, so.esr_scan_config(
        int(S), int(N), int(backward), ctypes.byref(stages),
        ctypes.byref(smem)))
    return {"stages": stages.value, "smem_bytes": smem.value}


def _require_ns(alpha: torch.Tensor, what: str) -> None:
    _require(alpha, torch.float32, what)
    if alpha.dim() != 2:
        raise ValueError(f"{what} must be [N, S], got {tuple(alpha.shape)}")


def scan_fwd(alpha: torch.Tensor, early_exit: float):
    """K-1 on ``alpha [N, S]``: returns ``(w, t_in [N, S], last [N])``."""
    _require_ns(alpha, "scan_fwd alpha")
    N, S = alpha.shape
    w = torch.empty_like(alpha)
    t_in = torch.empty_like(alpha)
    last = torch.empty((N,), dtype=torch.float32, device=alpha.device)
    so = lib("scan")
    _check("scan_fwd", so, so.esr_scan_fwd(
        _ptr(alpha), _ptr(w), _ptr(t_in), _ptr(last), S, N,
        float(early_exit), int(scan_tma_ok(S, alpha, w, t_in)),
        _stream(alpha)))
    launches["scan_fwd"] += 1
    return w, t_in, last


def scan_bwd(alpha, t_in, ct_w, ct_last, early_exit: float):
    """K-2: ``d_alpha [N, S]`` from the forward's ``t_in`` and the
    cotangents of the weights ``[N, S]`` and of ``last`` ``[N]``."""
    _require_ns(alpha, "scan_bwd alpha")
    for t, what in ((t_in, "t_in"), (ct_w, "ct_w"), (ct_last, "ct_last")):
        _require(t, torch.float32, f"scan_bwd {what}")
    N, S = alpha.shape
    if t_in.shape != (N, S) or ct_w.shape != (N, S) or ct_last.shape != (N,):
        raise ValueError("scan_bwd: shape mismatch")
    da = torch.empty_like(alpha)
    so = lib("scan")
    _check("scan_bwd", so, so.esr_scan_bwd(
        _ptr(alpha), _ptr(t_in), _ptr(ct_w), _ptr(ct_last), _ptr(da),
        S, N, float(early_exit), int(scan_tma_ok(S, alpha, t_in, ct_w, da)),
        _stream(alpha)))
    launches["scan_bwd"] += 1
    return da


def splat(base: torch.Tensor, vals: torch.Tensor, offsets: Sequence[int],
          out: torch.Tensor, n_valid=None) -> torch.Tensor:
    """K-3: accumulate ``vals [S, C, M]`` at rows ``base + offsets[s]`` of
    ``out [n_cells, C]`` (in place; the caller zeroes it)."""
    _require(base, torch.int32, "splat base")
    _require(vals, torch.float32, "splat vals")
    _require(out, torch.float32, "splat out")
    S, C, M = vals.shape
    if base.shape != (M,) or len(offsets) != S or out.shape[1] != C:
        raise ValueError("splat: shape mismatch")
    nv = _nv(n_valid, base.device)
    so = lib("splat")
    _check("splat", so, so.esr_splat(
        _ptr(base), _ptr(vals), _offsets(offsets), S, C, M, out.shape[0],
        _ptr(nv), _ptr(out), _stream(base)))
    launches["splat"] += 1
    return out


def gather_weighted(table, base, weights, offsets, n_valid=None):
    """K-4 weighted: ``out [M, C]`` from ``table [R, C]``, ``base [M]`` and
    ``weights [M, D]``."""
    _require(table, torch.float32, "gather table")
    _require(base, torch.int32, "gather base")
    _require(weights, torch.float32, "gather weights")
    R, C = table.shape
    M, D = weights.shape
    if base.shape != (M,) or len(offsets) != D:
        raise ValueError("gather_weighted: shape mismatch")
    out = torch.empty((M, C), dtype=torch.float32, device=table.device)
    nv = _nv(n_valid, table.device)
    so = lib("gather")
    _check("gather_weighted", so, so.esr_gather_weighted(
        _ptr(table), R, C, _ptr(base), _ptr(weights), _offsets(offsets), D, M,
        _ptr(nv), _ptr(out), _stream(table)))
    launches["gather_weighted"] += 1
    return out


def gather_raw(table, base, offsets, n_valid=None):
    """K-4 raw: ``out [M, D]`` per-offset values of a ``[R, 1]`` table."""
    _require(table, torch.float32, "gather table")
    _require(base, torch.int32, "gather base")
    R, C = table.shape
    if C != 1:
        raise ValueError("gather_raw needs a [R, 1] table")
    M, D = base.shape[0], len(offsets)
    out = torch.empty((M, D), dtype=torch.float32, device=table.device)
    nv = _nv(n_valid, table.device)
    so = lib("gather")
    _check("gather_raw", so, so.esr_gather_raw(
        _ptr(table), R, _ptr(base), _offsets(offsets), D, M, _ptr(nv),
        _ptr(out), _stream(table)))
    launches["gather_raw"] += 1
    return out


def gather_grid(tbl, idx, w0, gf, gl):
    """K-5: ``out [NCH, 24, 2048]`` from the flat table and int32 ``idx
    [NCH*16, 128]``, ``w0 [NCH]``, ``gf, gl [NCH, 16]``."""
    _require(tbl, torch.float32, "gather_grid tbl")
    for t, what in ((idx, "idx"), (w0, "w0"), (gf, "gf"), (gl, "gl")):
        _require(t, torch.int32, f"gather_grid {what}")
    nch = w0.shape[0]
    out = torch.empty((nch, 24, 2048), dtype=torch.float32, device=tbl.device)
    so = lib("gather_bench")
    _check("gather_grid", so, so.esr_gather_grid(
        _ptr(tbl), tbl.numel(), _ptr(idx), _ptr(w0), _ptr(gf), _ptr(gl), nch,
        _ptr(out), _stream(tbl)))
    launches["gather_grid"] += 1
    return out


_PARTS_MODES = {"dma": 0, "build": 1, "full": 2}


def gather_parts(tbl, mode: str, npiece: int):
    """K-6: ``out [1, 24, 2048]`` after sweeping ``npiece`` pieces of the
    flat table in ``mode`` (``dma``, ``build`` or ``full``). The table's
    base must be 16-byte aligned (the kernels read it by bulk copies)."""
    _require(tbl, torch.float32, "gather_parts tbl")
    if tbl.data_ptr() % 16:
        raise ValueError("gather_parts: the table's base must be 16-byte "
                         "aligned")
    out = torch.empty((1, 24, 2048), dtype=torch.float32, device=tbl.device)
    so = lib("gather_bench")
    _check(f"gather_parts_{mode}", so, so.esr_gather_parts(
        _ptr(tbl), tbl.numel(), int(npiece), _PARTS_MODES[mode], _ptr(out),
        _stream(tbl)))
    launches[f"gather_parts_{mode}"] += 1
    return out


# widths esr_eval_heads is built for: 192-wide heads of four layers on at
# most 96 inputs, a 192-wide tone-mapper of two on 3 + 6 P <= 48, 3 outputs
EVAL_HEADS_HIDDEN, EVAL_HEADS_MAX_IN, EVAL_HEADS_MAX_TM_IN = 192, 96, 48


def _mlp_shapes(mlp) -> list:
    return [(tuple(mlp[f"w{i}"].shape), tuple(mlp[f"b{i}"].shape))
            for i in range(mlpops.n_layers(mlp))]


def eval_heads_fit(off_rgbnet, emo_rgbnet, tonemapper, n_in: int) -> bool:
    """Whether :func:`eval_heads` is built for these heads (``[in, out]``
    weight dicts) on ``n_in`` head inputs."""
    H = EVAL_HEADS_HIDDEN
    head = [((n_in, H), (H,)), ((H, H), (H,)), ((H, H), (H,)),
            ((H, 3), (3,))]
    tm = _mlp_shapes(tonemapper)
    tm_in = tm[0][0][0] if tm else 0
    return (n_in <= EVAL_HEADS_MAX_IN
            and _mlp_shapes(off_rgbnet) == head
            and _mlp_shapes(emo_rgbnet) == head
            and tm_in <= EVAL_HEADS_MAX_TM_IN and (tm_in - 3) % 6 == 0
            and tm == [((tm_in, H), (H,)), ((H, 3), (3,))])


def eval_heads(off_gv, emo_gv, feat, nrm, weights, ray_id, step_id, n_valid,
               n_rays: int, stepdist: float, off_rgbnet, emo_rgbnet,
               tonemapper, compute_dtype=torch.bfloat16):
    """The fine eval heads and their per-ray sums in one pass over the rows
    before ``n_valid`` (``csrc/heads.cu``): both radiance heads on ``[gv |
    feat]``, the tone-mapper on off, emo and on, and the weighted sums by
    ``ray_id``. Returns views of one zeroed buffer: ``(srgb_off, lin_off,
    srgb_on, lin_on, srgb_emo, lin_emo, normal)`` ``[n_rays, 3]`` each and
    the depth ``[n_rays]``. Raises for heads it is not built for: a
    ``compute_dtype`` other than bf16, or widths :func:`eval_heads_fit`
    refuses."""
    mlps = (off_rgbnet, emo_rgbnet)
    M, C_g = off_gv.shape
    F = feat.shape[1]
    if compute_dtype != torch.bfloat16 or not eval_heads_fit(
            *mlps, tonemapper, C_g + F):
        raise ValueError(
            "eval_heads: built for bf16 heads of in -> 192 x 3 -> 3 (in <= "
            f"{EVAL_HEADS_MAX_IN}) and a 3 + 6 P -> 192 -> 3 "
            f"tone-mapper (3 + 6 P <= {EVAL_HEADS_MAX_TM_IN}); got "
            f"{compute_dtype or torch.float32} heads of "
            f"{_mlp_shapes(off_rgbnet)} on {C_g + F} inputs, tone-mapper "
            f"{_mlp_shapes(tonemapper)}")
    for t, what in ((off_gv, "off_gv"), (emo_gv, "emo_gv"), (feat, "feat"),
                    (nrm, "nrm"), (weights, "weights")):
        _require(t, torch.float32, f"eval_heads {what}")
    for t, what in ((ray_id, "ray_id"), (step_id, "step_id")):
        _require(t, torch.int64, f"eval_heads {what}")
    if (emo_gv.shape != (M, C_g) or feat.shape != (M, F)
            or nrm.shape != (M, 3) or weights.shape != (M,)
            or ray_id.shape != (M,) or step_id.shape != (M,)):
        raise ValueError("eval_heads: row counts or widths of the inputs "
                         "differ")
    params = [m[f"{k}{i}"] for m in mlps for k in "wb" for i in range(4)]
    params += [tonemapper[k] for k in ("w0", "w1", "b0", "b1")]
    for i, t in enumerate(params):
        _require(t, torch.float32, f"eval_heads weight {i}")
    N = int(n_rays)
    out = torch.zeros((22 * N,), dtype=torch.float32, device=feat.device)
    nv = _nv(n_valid, feat.device)
    ts = (off_gv, emo_gv, feat, nrm, weights, ray_id, step_id, nv, *params,
          out)
    ptrs = (ctypes.c_void_p * len(ts))(*[_ptr(t) for t in ts])
    P = (tonemapper["w0"].shape[0] - 3) // 6
    so = lib("heads")
    _check("eval_heads", so, so.esr_eval_heads(
        ptrs, M, N, C_g, F, P, float(stepdist), _stream(feat)))
    launches["eval_heads"] += 1
    sums = [out[3 * N * i:3 * N * (i + 1)].view(N, 3) for i in range(7)]
    return (*sums, out[21 * N:])
