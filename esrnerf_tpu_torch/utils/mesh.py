"""Mesh extraction and PLY export.

Port of ``esrnerf_tpu/utils/mesh.py``: the scalar field is sampled on the
model's device (:func:`extract_fields`), its isosurface is extracted by
marching tetrahedra (:func:`marching_cubes`) and written as a binary PLY
(:func:`export_ply`); :func:`load_ply` reads a PLY's vertices back (the
DTU point clouds). A field on the CPU takes the vectorised numpy
marching tetrahedra, the plain version; a field on the card is copied to
the host once and meshed by the C++ extractor ``csrc/marching.cpp``, built
by :mod:`esrnerf_tpu_torch.ops.kernels`. If that build fails the call
raises: a 512^3 field is far too slow for the numpy version. Both give the
same vertices and triangles up to their order.
"""

from __future__ import annotations

import ctypes
from typing import Callable, Union

import numpy as np
import torch

# 6-tet decomposition of each cell around the (0,0,0)-(1,1,1) diagonal
# (must match csrc/marching.cpp)
_TETS = np.array(
    [
        [[0, 0, 0], [1, 0, 0], [1, 1, 0], [1, 1, 1]],
        [[0, 0, 0], [1, 1, 0], [0, 1, 0], [1, 1, 1]],
        [[0, 0, 0], [0, 1, 0], [0, 1, 1], [1, 1, 1]],
        [[0, 0, 0], [0, 1, 1], [0, 0, 1], [1, 1, 1]],
        [[0, 0, 0], [0, 0, 1], [1, 0, 1], [1, 1, 1]],
        [[0, 0, 0], [1, 0, 1], [1, 0, 0], [1, 1, 1]],
    ]
)


def _marching_tets_numpy(field: np.ndarray, thresh: float):
    """Vectorised numpy marching tetrahedra: ``(verts [V, 3] f32 in index
    space, tris [T, 3] int64)``; edge vertices are shared."""
    nx, ny, nz = field.shape
    xs, ys, zs = np.meshgrid(
        np.arange(nx - 1), np.arange(ny - 1), np.arange(nz - 1), indexing="ij"
    )
    base = np.stack([xs, ys, zs], -1).reshape(-1, 3)  # [C,3]

    def node_id(p):  # [?,3] -> linear
        return (p[..., 0] * ny + p[..., 1]) * nz + p[..., 2]

    fflat = field.reshape(-1)
    tris_edges = []  # list of [T,3,2] node-id pairs
    for t in range(6):
        corners = base[:, None, :] + _TETS[t][None]  # [C,4,3]
        ids = node_id(corners)  # [C,4]
        vals = fflat[ids]
        inside = vals > thresh  # [C,4]
        n_in = inside.sum(-1)

        for lone_side, cnt in ((True, 1), (False, 3)):
            sel = n_in == cnt
            if not sel.any():
                continue
            ids_s, in_s = ids[sel], inside[sel]
            lone_mask = in_s == lone_side
            lone = ids_s[lone_mask].reshape(-1)
            oth = ids_s[~lone_mask].reshape(-1, 3)
            e = np.stack(
                [
                    np.stack([lone, oth[:, 0]], -1),
                    np.stack([lone, oth[:, 1]], -1),
                    np.stack([lone, oth[:, 2]], -1),
                ],
                1,
            )
            tris_edges.append(e)

        sel = n_in == 2
        if sel.any():
            ids_s, in_s = ids[sel], inside[sel]
            pos = ids_s[in_s].reshape(-1, 2)
            neg = ids_s[~in_s].reshape(-1, 2)
            a = np.stack([pos[:, 0], neg[:, 0]], -1)
            b = np.stack([pos[:, 0], neg[:, 1]], -1)
            d = np.stack([pos[:, 1], neg[:, 1]], -1)
            e2 = np.stack([pos[:, 1], neg[:, 0]], -1)
            tris_edges.append(np.stack([a, b, d], 1))
            tris_edges.append(np.stack([a, d, e2], 1))

    if not tris_edges:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int64)

    edges = np.concatenate(tris_edges, 0).reshape(-1, 2)  # [3T, 2]
    edges_sorted = np.sort(edges, axis=-1)
    keys = edges_sorted[:, 0] * (nx * ny * nz) + edges_sorted[:, 1]
    uniq, inv = np.unique(keys, return_inverse=True)
    ea = (uniq // (nx * ny * nz)).astype(np.int64)
    eb = (uniq % (nx * ny * nz)).astype(np.int64)
    fa, fb = fflat[ea], fflat[eb]
    tt = np.clip((thresh - fa) / (fb - fa), 0.0, 1.0)

    def coords(i):
        return np.stack(
            [i // (ny * nz), (i // nz) % ny, i % nz], -1
        ).astype(np.float32)

    verts = coords(ea) + tt[:, None] * (coords(eb) - coords(ea))
    tris = inv.reshape(-1, 3).astype(np.int64)
    return verts.astype(np.float32), tris


def _marching_tets_native(field: np.ndarray, thresh: float):
    from esrnerf_tpu_torch.ops import kernels

    lib = kernels.lib("marching")
    h = lib.mt_extract(
        field.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        *[int(s) for s in field.shape], float(thresh),
    )
    try:
        nv, nt = lib.mt_num_verts(h), lib.mt_num_tris(h)
        verts = np.empty((nv, 3), np.float32)
        tris = np.empty((nt, 3), np.int64)
        if nv:
            lib.mt_copy(
                h, verts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                tris.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            )
    finally:
        lib.mt_free(h)
    return verts, tris


def marching_cubes(field: Union[torch.Tensor, np.ndarray], thresh: float = 0.0):
    """Isosurface ``field == thresh`` of a ``[nx, ny, nz]`` field as
    ``(verts [V, 3] f32, tris [T, 3] int64)``, vertices in index space (the
    caller rescales). A CUDA tensor is meshed by the C++ extractor, anything
    else by the numpy version."""
    if isinstance(field, torch.Tensor) and field.is_cuda:
        host = np.ascontiguousarray(field.detach().cpu().numpy(), np.float32)
        return _marching_tets_native(host, thresh)
    if isinstance(field, torch.Tensor):
        field = field.detach().numpy()
    return _marching_tets_numpy(np.ascontiguousarray(field, np.float32),
                                thresh)


def extract_fields(
    bound_min,
    bound_max,
    resolution: int,
    query_func: Callable[[torch.Tensor], torch.Tensor],
    max_points: int = 2**22,
    device="cuda",
) -> torch.Tensor:
    """A scalar field on the ``resolution^3`` lattice spanning the bounds
    (``numpy.linspace`` f32 axes, as the JAX package's) as a tensor on
    ``device``. ``query_func`` maps points ``[M, 3]`` on ``device`` to
    values ``[M]``; it is called on whole x-planes, at most about
    ``max_points`` points at a time."""
    axes = [torch.as_tensor(np.linspace(bound_min[i], bound_max[i],
                                        resolution, dtype=np.float32),
                            device=device) for i in range(3)]
    u = torch.empty((resolution,) * 3, dtype=torch.float32, device=device)
    slab = max(1, max_points // (resolution * resolution))
    for x0 in range(0, resolution, slab):
        xx, yy, zz = torch.meshgrid(axes[0][x0:x0 + slab], axes[1], axes[2],
                                    indexing="ij")
        pts = torch.stack([xx, yy, zz], -1).reshape(-1, 3)
        u[x0:x0 + slab] = query_func(pts).reshape(xx.shape)
    return u


def export_ply(path: str, vertices: np.ndarray, faces: np.ndarray) -> None:
    """Binary little-endian PLY of a triangle mesh."""
    vertices = np.asarray(vertices, np.float32)
    faces = np.asarray(faces, np.int32)
    header = (
        "ply\nformat binary_little_endian 1.0\n"
        f"element vertex {len(vertices)}\n"
        "property float x\nproperty float y\nproperty float z\n"
        f"element face {len(faces)}\n"
        "property list uchar int vertex_indices\nend_header\n"
    )
    face_rec = np.zeros(len(faces), dtype=[("n", "u1"), ("idx", "<i4", (3,))])
    face_rec["n"] = 3
    face_rec["idx"] = faces
    with open(path, "wb") as f:
        f.write(header.encode())
        f.write(vertices.astype("<f4").tobytes())
        f.write(face_rec.tobytes())


def load_ply(path: str):
    """Vertices of a binary or ascii PLY as ``(verts [V, 3] f32, faces)``;
    faces come back empty (the DTU STL point clouds have none)."""
    with open(path, "rb") as f:
        data = f.read()
    end = data.index(b"end_header\n") + len(b"end_header\n")
    header = data[:end].decode("ascii", "replace").splitlines()
    n_vert = 0
    props: list = []
    fmt = "binary_little_endian"
    cur = None
    for line in header:
        parts = line.split()
        if not parts:
            continue
        if parts[0] == "format":
            fmt = parts[1]
        elif parts[0] == "element":
            cur = parts[1]
            if cur == "vertex":
                n_vert = int(parts[2])
        elif parts[0] == "property" and cur == "vertex" and parts[1] != "list":
            props.append((parts[2], parts[1]))

    type_map = {"float": "<f4", "float32": "<f4", "double": "<f8",
                "uchar": "u1", "uint8": "u1", "int": "<i4", "short": "<i2",
                "ushort": "<u2"}
    names = [p[0] for p in props]
    if fmt.startswith("ascii"):
        body = data[end:].decode().split()
        arr = np.array(body[: n_vert * len(props)], np.float64).reshape(
            n_vert, len(props))
        verts = arr[:, [names.index("x"), names.index("y"), names.index("z")]]
        return verts.astype(np.float32), np.zeros((0, 3), np.int64)

    dtype = np.dtype([(name, type_map[t]) for name, t in props])
    arr = np.frombuffer(data, dtype=dtype, count=n_vert, offset=end)
    verts = np.stack([arr["x"], arr["y"], arr["z"]], -1).astype(np.float32)
    return verts, np.zeros((0, 3), np.int64)
