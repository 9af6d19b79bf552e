"""Marching cubes on a dense scalar field — counterpart of the reference's
GPU marching cubes (``src/marching_cubes.cu``: vertex generation along grid
edges, face generation from the case table, welded via an edge-index grid).

Static-shape formulation: instead of atomic vertex allocation, vertices live
on the three positive-direction edges of every cell (a dense (X,Y,Z,3)
edge grid); crossing edges are compacted with a cumsum enumeration, faces
index into the edge grid and are remapped through the compaction — fully
vectorized numpy/JAX, no atomics, welded by construction (the same edge is
shared by all adjacent faces). Runs in numpy on host (mesh export is a
host-side product, like the reference's ``compute_mesh_on_gpu`` feeding an
OBJ writer).
"""

from __future__ import annotations

import numpy as np

# Standard public marching-cubes tables (Lorensen & Cline; the same tables
# the reference embeds in marching_cubes.cu).
_EDGE_VERTS = np.asarray(
    [
        (0, 1), (1, 2), (2, 3), (3, 0),
        (4, 5), (5, 6), (6, 7), (7, 4),
        (0, 4), (1, 5), (2, 6), (3, 7),
    ],
    np.int32,
)

_CORNER_OFFSET = np.asarray(
    [
        (0, 0, 0), (1, 0, 0), (1, 1, 0), (0, 1, 0),
        (0, 0, 1), (1, 0, 1), (1, 1, 1), (0, 1, 1),
    ],
    np.int32,
)

# fmt: off
_TRI_TABLE_STR = (
    "-1;0 8 3;0 1 9;1 8 3 9 8 1;1 2 10;0 8 3 1 2 10;9 2 10 0 2 9;"
    "2 8 3 2 10 8 10 9 8;3 11 2;0 11 2 8 11 0;1 9 0 2 3 11;"
    "1 11 2 1 9 11 9 8 11;3 10 1 11 10 3;0 10 1 0 8 10 8 11 10;"
    "3 9 0 3 11 9 11 10 9;9 8 10 10 8 11;4 7 8;4 3 0 7 3 4;0 1 9 8 4 7;"
    "4 1 9 4 7 1 7 3 1;1 2 10 8 4 7;3 4 7 3 0 4 1 2 10;"
    "9 2 10 9 0 2 8 4 7;2 10 9 2 9 7 2 7 3 7 9 4;8 4 7 3 11 2;"
    "11 4 7 11 2 4 2 0 4;9 0 1 8 4 7 2 3 11;"
    "4 7 11 9 4 11 9 11 2 9 2 1;3 10 1 3 11 10 7 8 4;"
    "1 11 10 1 4 11 1 0 4 7 11 4;4 7 8 9 0 11 9 11 10 11 0 3;"
    "4 7 11 4 11 9 9 11 10;9 5 4;9 5 4 0 8 3;0 5 4 1 5 0;"
    "8 5 4 8 3 5 3 1 5;1 2 10 9 5 4;3 0 8 1 2 10 4 9 5;"
    "5 2 10 5 4 2 4 0 2;2 10 5 3 2 5 3 5 4 3 4 8;9 5 4 2 3 11;"
    "0 11 2 0 8 11 4 9 5;0 5 4 0 1 5 2 3 11;"
    "2 1 5 2 5 8 2 8 11 4 8 5;10 3 11 10 1 3 9 5 4;"
    "4 9 5 0 8 1 8 10 1 8 11 10;5 4 0 5 0 11 5 11 10 11 0 3;"
    "5 4 8 5 8 10 10 8 11;9 7 8 5 7 9;9 3 0 9 5 3 5 7 3;"
    "0 7 8 0 1 7 1 5 7;1 5 3 3 5 7;9 7 8 9 5 7 10 1 2;"
    "10 1 2 9 5 0 5 3 0 5 7 3;8 0 2 8 2 5 8 5 7 10 5 2;"
    "2 10 5 2 5 3 3 5 7;7 9 5 7 8 9 3 11 2;"
    "9 5 7 9 7 2 9 2 0 2 7 11;2 3 11 0 1 8 1 7 8 1 5 7;"
    "11 2 1 11 1 7 7 1 5;9 5 8 8 5 7 10 1 3 10 3 11;"
    "5 7 0 5 0 9 7 11 0 1 0 10 11 10 0;11 10 0 11 0 3 10 5 0 8 0 7 5 7 0;"
    "11 10 5 7 11 5;10 6 5;0 8 3 5 10 6;9 0 1 5 10 6;"
    "1 8 3 1 9 8 5 10 6;1 6 5 2 6 1;1 6 5 1 2 6 3 0 8;"
    "9 6 5 9 0 6 0 2 6;5 9 8 5 8 2 5 2 6 3 2 8;2 3 11 10 6 5;"
    "11 0 8 11 2 0 10 6 5;0 1 9 2 3 11 5 10 6;"
    "5 10 6 1 9 2 9 11 2 9 8 11;6 3 11 6 5 3 5 1 3;"
    "0 8 11 0 11 5 0 5 1 5 11 6;3 11 6 0 3 6 0 6 5 0 5 9;"
    "6 5 9 6 9 11 11 9 8;5 10 6 4 7 8;4 3 0 4 7 3 6 5 10;"
    "1 9 0 5 10 6 8 4 7;10 6 5 1 9 7 1 7 3 7 9 4;"
    "6 1 2 6 5 1 4 7 8;1 2 5 5 2 6 3 0 4 3 4 7;"
    "8 4 7 9 0 5 0 6 5 0 2 6;7 3 9 7 9 4 3 2 9 5 9 6 2 6 9;"
    "3 11 2 7 8 4 10 6 5;5 10 6 4 7 2 4 2 0 2 7 11;"
    "0 1 9 4 7 8 2 3 11 5 10 6;9 2 1 9 11 2 9 4 11 7 11 4 5 10 6;"
    "8 4 7 3 11 5 3 5 1 5 11 6;5 1 11 5 11 6 1 0 11 7 11 4 0 4 11;"
    "0 5 9 0 6 5 0 3 6 11 6 3 8 4 7;6 5 9 6 9 11 4 7 9 7 11 9;"
    "10 4 9 6 4 10;4 10 6 4 9 10 0 8 3;10 0 1 10 6 0 6 4 0;"
    "8 3 1 8 1 6 8 6 4 6 1 10;1 4 9 1 2 4 2 6 4;"
    "3 0 8 1 2 9 2 4 9 2 6 4;0 2 4 4 2 6;8 3 2 8 2 4 4 2 6;"
    "10 4 9 10 6 4 11 2 3;0 8 2 2 8 11 4 9 10 4 10 6;"
    "3 11 2 0 1 6 0 6 4 6 1 10;6 4 1 6 1 10 4 8 1 2 1 11 8 11 1;"
    "9 6 4 9 3 6 9 1 3 11 6 3;8 11 1 8 1 0 11 6 1 9 1 4 6 4 1;"
    "3 11 6 3 6 0 0 6 4;6 4 8 11 6 8;7 10 6 7 8 10 8 9 10;"
    "0 7 3 0 10 7 0 9 10 6 7 10;10 6 7 1 10 7 1 7 8 1 8 0;"
    "10 6 7 10 7 1 1 7 3;1 2 6 1 6 8 1 8 9 8 6 7;"
    "2 6 9 2 9 1 6 7 9 0 9 3 7 3 9;7 8 0 7 0 6 6 0 2;7 3 2 6 7 2;"
    "2 3 11 10 6 8 10 8 9 8 6 7;2 0 7 2 7 11 0 9 7 6 7 10 9 10 7;"
    "1 8 0 1 7 8 1 10 7 6 7 10 2 3 11;11 2 1 11 1 7 10 6 1 6 7 1;"
    "8 9 6 8 6 7 9 1 6 11 6 3 1 3 6;0 9 1 11 6 7;"
    "7 8 0 7 0 6 3 11 0 11 6 0;7 11 6;7 6 11;3 0 8 11 7 6;"
    "0 1 9 11 7 6;8 1 9 8 3 1 11 7 6;10 1 2 6 11 7;"
    "1 2 10 3 0 8 6 11 7;2 9 0 2 10 9 6 11 7;"
    "6 11 7 2 10 3 10 8 3 10 9 8;7 2 3 6 2 7;7 0 8 7 6 0 6 2 0;"
    "2 7 6 2 3 7 0 1 9;1 6 2 1 8 6 1 9 8 8 7 6;10 7 6 10 1 7 1 3 7;"
    "10 7 6 1 7 10 1 8 7 1 0 8;0 3 7 0 7 10 0 10 9 6 10 7;"
    "7 6 10 7 10 8 8 10 9;6 8 4 11 8 6;3 6 11 3 0 6 0 4 6;"
    "8 6 11 8 4 6 9 0 1;9 4 6 9 6 3 9 3 1 11 3 6;6 8 4 6 11 8 2 10 1;"
    "1 2 10 3 0 11 0 6 11 0 4 6;4 11 8 4 6 11 0 2 9 2 10 9;"
    "10 9 3 10 3 2 9 4 3 11 3 6 4 6 3;8 2 3 8 4 2 4 6 2;0 4 2 4 6 2;"
    "1 9 0 2 3 4 2 4 6 4 3 8;1 9 4 1 4 2 2 4 6;"
    "8 1 3 8 6 1 8 4 6 6 10 1;10 1 0 10 0 6 6 0 4;"
    "4 6 3 4 3 8 6 10 3 0 3 9 10 9 3;10 9 4 6 10 4;4 9 5 7 6 11;"
    "0 8 3 4 9 5 11 7 6;5 0 1 5 4 0 7 6 11;"
    "11 7 6 8 3 4 3 5 4 3 1 5;9 5 4 10 1 2 7 6 11;"
    "6 11 7 1 2 10 0 8 3 4 9 5;7 6 11 5 4 10 4 2 10 4 0 2;"
    "3 4 8 3 5 4 3 2 5 10 5 2 11 7 6;7 2 3 7 6 2 5 4 9;"
    "9 5 4 0 8 6 0 6 2 6 8 7;3 6 2 3 7 6 1 5 0 5 4 0;"
    "6 2 8 6 8 7 2 1 8 4 8 5 1 5 8;9 5 4 10 1 6 1 7 6 1 3 7;"
    "1 6 10 1 7 6 1 0 7 8 7 0 9 5 4;4 0 10 4 10 5 0 3 10 6 10 7 3 7 10;"
    "7 6 10 7 10 8 5 4 10 4 8 10;6 9 5 6 11 9 11 8 9;"
    "3 6 11 0 6 3 0 5 6 0 9 5;0 11 8 0 5 11 0 1 5 5 6 11;"
    "6 11 3 6 3 5 5 3 1;1 2 10 9 5 11 9 11 8 11 5 6;"
    "0 11 3 0 6 11 0 9 6 5 6 9 1 2 10;11 8 5 11 5 6 8 0 5 10 5 2 0 2 5;"
    "6 11 3 6 3 5 2 10 3 10 5 3;5 8 9 5 2 8 5 6 2 3 8 2;"
    "9 5 6 9 6 0 0 6 2;1 5 8 1 8 0 5 6 8 3 8 2 6 2 8;1 5 6 2 1 6;"
    "1 3 6 1 6 10 3 8 6 5 6 9 8 9 6;10 1 0 10 0 6 9 5 0 5 6 0;"
    "0 3 8 5 6 10;10 5 6;11 5 10 7 5 11;11 5 10 11 7 5 8 3 0;"
    "5 11 7 5 10 11 1 9 0;10 7 5 10 11 7 9 8 1 8 3 1;"
    "11 1 2 11 7 1 7 5 1;0 8 3 1 2 7 1 7 5 7 2 11;"
    "9 7 5 9 2 7 9 0 2 2 11 7;7 5 2 7 2 11 5 9 2 3 2 8 9 8 2;"
    "2 5 10 2 3 5 3 7 5;8 2 0 8 5 2 8 7 5 10 2 5;"
    "9 0 1 5 10 3 5 3 7 3 10 2;9 8 2 9 2 1 8 7 2 10 2 5 7 5 2;"
    "1 3 5 3 7 5;0 8 7 0 7 1 1 7 5;9 0 3 9 3 5 5 3 7;9 8 7 5 9 7;"
    "5 8 4 5 10 8 10 11 8;5 0 4 5 11 0 5 10 11 11 3 0;"
    "0 1 9 8 4 10 8 10 11 10 4 5;10 11 4 10 4 5 11 3 4 9 4 1 3 1 4;"
    "2 5 1 2 8 5 2 11 8 4 5 8;0 4 11 0 11 3 4 5 11 2 11 1 5 1 11;"
    "0 2 5 0 5 9 2 11 5 4 5 8 11 8 5;9 4 5 2 11 3;"
    "2 5 10 3 5 2 3 4 5 3 8 4;5 10 2 5 2 4 4 2 0;"
    "3 10 2 3 5 10 3 8 5 4 5 8 0 1 9;5 10 2 5 2 4 1 9 2 9 4 2;"
    "8 4 5 8 5 3 3 5 1;0 4 5 1 0 5;8 4 5 8 5 3 9 0 5 0 3 5;9 4 5;"
    "4 11 7 4 9 11 9 10 11;0 8 3 4 9 7 9 11 7 9 10 11;"
    "1 10 11 1 11 4 1 4 0 7 4 11;3 1 4 3 4 8 1 10 4 7 4 11 10 11 4;"
    "4 11 7 9 11 4 9 2 11 9 1 2;9 7 4 9 11 7 9 1 11 2 11 1 0 8 3;"
    "11 7 4 11 4 2 2 4 0;11 7 4 11 4 2 8 3 4 3 2 4;"
    "2 9 10 2 7 9 2 3 7 7 4 9;9 10 7 9 7 4 10 2 7 8 7 0 2 0 7;"
    "3 7 10 3 10 2 7 4 10 1 10 0 4 0 10;1 10 2 8 7 4;4 9 1 4 1 7 7 1 3;"
    "4 9 1 4 1 7 0 8 1 8 7 1;4 0 3 7 4 3;4 8 7;9 10 8 10 11 8;"
    "3 0 9 3 9 11 11 9 10;0 1 10 0 10 8 8 10 11;3 1 10 11 3 10;"
    "1 2 11 1 11 9 9 11 8;3 0 9 3 9 11 1 2 9 2 11 9;0 2 11 8 0 11;"
    "3 2 11;2 3 8 2 8 10 10 8 9;9 10 2 0 9 2;"
    "2 3 8 2 8 10 0 1 8 1 10 8;1 10 2;1 3 8 9 1 8;0 9 1;0 3 8;-1"
)
# fmt: on

_TRI_TABLE = [
    np.asarray([int(t) for t in row.split()] if row != "-1" else [], np.int32)
    for row in _TRI_TABLE_STR.split(";")
]
assert len(_TRI_TABLE) == 256


def marching_cubes(
    field: np.ndarray, threshold: float = 0.0, origin=None, spacing=None
):
    """Extract the ``field > threshold`` isosurface.

    ``field`` is (X, Y, Z) float; returns (verts (V, 3) float32, faces
    (F, 3) int32) with welded vertices. ``origin``/``spacing`` map grid
    indices to world coordinates (defaults: index space)."""
    field = np.asarray(field, np.float32)
    X, Y, Z = field.shape
    inside = field > threshold

    # cube case index per cell
    case = np.zeros((X - 1, Y - 1, Z - 1), np.int32)
    for ci, (dx, dy, dz) in enumerate(_CORNER_OFFSET):
        case |= inside[dx : X - 1 + dx, dy : Y - 1 + dy, dz : Z - 1 + dz] << ci

    # dense edge-vertex grid: edge e of cell c lives on one of the three
    # positive edges of some node: edge -> (node offset, axis)
    edge_map = []
    for (a, b) in _EDGE_VERTS:
        o0, o1 = _CORNER_OFFSET[a], _CORNER_OFFSET[b]
        axis = int(np.argmax(np.abs(o1 - o0)))
        node = np.minimum(o0, o1)
        edge_map.append((node, axis))

    # crossing mask on the (X, Y, Z, 3) edge grid
    cross = np.zeros((X, Y, Z, 3), bool)
    d = [
        inside[1:, :, :] != inside[:-1, :, :],
        inside[:, 1:, :] != inside[:, :-1, :],
        inside[:, :, 1:] != inside[:, :, :-1],
    ]
    cross[: X - 1, :, :, 0] = d[0]
    cross[:, : Y - 1, :, 1] = d[1]
    cross[:, :, : Z - 1, 2] = d[2]

    vid = np.full(cross.shape, -1, np.int64)
    flat_ids = np.cumsum(cross.reshape(-1)) - 1
    vid.reshape(-1)[:] = np.where(cross.reshape(-1), flat_ids, -1)
    n_verts = int(cross.sum())

    # vertex positions by linear interpolation along the crossing edge
    verts = np.zeros((n_verts, 3), np.float32)
    for axis in range(3):
        idx = np.argwhere(cross[..., axis])
        if idx.size == 0:
            continue
        i, j, k = idx[:, 0], idx[:, 1], idx[:, 2]
        v0 = field[i, j, k]
        step = np.zeros(3, np.int32)
        step[axis] = 1
        v1 = field[i + step[0], j + step[1], k + step[2]]
        t = (threshold - v0) / np.where(np.abs(v1 - v0) > 1e-12, v1 - v0, 1.0)
        t = np.clip(t, 0.0, 1.0)
        p = np.stack([i, j, k], -1).astype(np.float32)
        p[:, axis] += t
        verts[vid[i, j, k, axis]] = p

    # faces from the case table
    faces = []
    cells = np.argwhere((case > 0) & (case < 255))
    for ci, cj, ck in cells:
        tri = _TRI_TABLE[case[ci, cj, ck]]
        for f in range(0, len(tri), 3):
            ids = []
            for e in tri[f : f + 3]:
                node, axis = edge_map[e]
                ids.append(vid[ci + node[0], cj + node[1], ck + node[2], axis])
            faces.append(ids)
    # flip winding so normals point outward for inside-positive fields
    # (density grids); pass the negated field for SDFs
    faces = np.asarray(faces, np.int32).reshape(-1, 3)[:, ::-1]

    if origin is not None or spacing is not None:
        origin = np.zeros(3, np.float32) if origin is None else np.asarray(origin)
        spacing = np.ones(3, np.float32) if spacing is None else np.asarray(spacing)
        verts = verts * spacing + origin
    return verts, faces


def save_obj(path: str, verts: np.ndarray, faces: np.ndarray) -> None:
    """Write a mesh as ASCII OBJ (``save_mesh``, ``marching_cubes.cu:806``)."""
    with open(path, "w") as f:
        for v in verts:
            f.write(f"v {v[0]} {v[1]} {v[2]}\n")
        for t in faces:
            f.write(f"f {t[0] + 1} {t[1] + 1} {t[2] + 1}\n")


def save_ply(path: str, verts: np.ndarray, faces: np.ndarray) -> None:
    with open(path, "wb") as f:
        head = (
            "ply\nformat ascii 1.0\n"
            f"element vertex {len(verts)}\n"
            "property float x\nproperty float y\nproperty float z\n"
            f"element face {len(faces)}\n"
            "property list uchar int vertex_indices\nend_header\n"
        )
        f.write(head.encode())
        for v in verts:
            f.write(f"{v[0]} {v[1]} {v[2]}\n".encode())
        for t in faces:
            f.write(f"3 {t[0]} {t[1]} {t[2]}\n".encode())
