"""Procedural test meshes (host-side NumPy).

A copy of the parts of ``jl_tpu/utils/mesh_io.py`` the port's main paths use
(``Mesh``, the cube, icosphere and "monkey" blob generators,
``mesh_diameter``, ``fix_winding`` and the Wavefront OBJ reader
``load_obj``); the port keeps its own copy rather than importing the JAX
package. Devices only ever see dense ``(verts, faces)`` tensors.
"""

from __future__ import annotations

import numpy as np

__all__ = ["Mesh", "cube_mesh", "icosphere_mesh", "monkey_mesh", "mesh_diameter", "fix_winding",
           "load_obj"]


class Mesh:
    """Host-side triangle mesh: float32 vertices [V, 3], int32 faces [F, 3]."""

    def __init__(self, vertices: np.ndarray, faces: np.ndarray):
        self.vertices = np.ascontiguousarray(vertices, dtype=np.float32)
        self.faces = np.ascontiguousarray(faces, dtype=np.int32)

    @property
    def n_vertices(self):
        return self.vertices.shape[0]

    @property
    def n_faces(self):
        return self.faces.shape[0]

    def __repr__(self):
        return f"Mesh({self.n_vertices} verts, {self.n_faces} faces)"


def cube_mesh(side: float = 0.1) -> Mesh:
    """Axis-aligned cube centered at the origin (12 outward-wound triangles)."""
    h = side / 2
    verts = np.array(
        [
            [-h, -h, -h], [h, -h, -h], [h, h, -h], [-h, h, -h],
            [-h, -h, h], [h, -h, h], [h, h, h], [-h, h, h],
        ],
        np.float32,
    )
    faces = np.array(
        [
            [0, 2, 1], [0, 3, 2],  # -z
            [4, 5, 6], [4, 6, 7],  # +z
            [0, 1, 5], [0, 5, 4],  # -y
            [2, 3, 7], [2, 7, 6],  # +y
            [1, 2, 6], [1, 6, 5],  # +x
            [3, 0, 4], [3, 4, 7],  # -x
        ],
        np.int32,
    )
    return Mesh(verts, faces)


def icosphere_mesh(radius: float = 0.05, subdivisions: int = 2) -> Mesh:
    """Icosphere via subdivided icosahedron (20 * 4^n faces)."""
    t = (1.0 + np.sqrt(5.0)) / 2.0
    verts = np.array(
        [
            [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
            [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
            [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1],
        ],
        np.float64,
    )
    verts /= np.linalg.norm(verts, axis=1, keepdims=True)
    faces = np.array(
        [
            [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
            [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
            [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
            [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
        ],
        np.int64,
    )
    for _ in range(subdivisions):
        edge_mid: dict = {}
        new_faces = []
        verts_list = list(verts)

        def midpoint(i, j):
            key = (min(i, j), max(i, j))
            if key not in edge_mid:
                m = (verts_list[i] + verts_list[j]) / 2.0
                m /= np.linalg.norm(m)
                edge_mid[key] = len(verts_list)
                verts_list.append(m)
            return edge_mid[key]

        for a, b, c in faces:
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            new_faces += [[a, ab, ca], [b, bc, ab], [c, ca, bc], [ab, bc, ca]]
        verts = np.asarray(verts_list)
        faces = np.asarray(new_faces, np.int64)
    return Mesh((verts * radius).astype(np.float32), faces.astype(np.int32))


def monkey_mesh(size: float = 0.08) -> Mesh:
    """Deterministic non-convex blob (deformed icosphere, 1280 faces, 642
    vertices): the benchmark mesh."""
    base = icosphere_mesh(1.0, 3)
    v = base.vertices.astype(np.float64)
    x, y, z = v[:, 0], v[:, 1], v[:, 2]
    bump = (
        1.0
        + 0.25 * np.sin(3 * x) * np.cos(2 * y)
        + 0.2 * np.cos(4 * z) * np.sin(2 * x)
        + 0.15 * np.sin(5 * y) * np.cos(3 * z)
    )
    v = v * bump[:, None]
    v = v / np.abs(v).max() * (size / 2)
    return Mesh(v.astype(np.float32), base.faces)


def mesh_diameter(mesh: Mesh) -> float:
    """Largest pairwise vertex distance (object diameter, used for crop sizing)."""
    v = mesh.vertices
    if len(v) > 2000:
        # hull-ish subsample: extreme points along many directions
        rng = np.random.default_rng(0)
        dirs = rng.normal(size=(64, 3))
        dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
        idx = np.unique(np.concatenate([np.argmax(v @ dirs.T, 0), np.argmin(v @ dirs.T, 0)]))
        v = v[idx]
    d2 = ((v[:, None, :] - v[None, :, :]) ** 2).sum(-1)
    return float(np.sqrt(d2.max()))


def fix_winding(mesh: Mesh) -> Mesh:
    """All faces flipped if the signed volume is negative (majority-inward
    winding), so that back-face culling keeps the outside. Assumes one
    winding per mesh, as watertight CAD models have."""
    tri = mesh.vertices[mesh.faces].astype(np.float64)
    svol = np.einsum("fi,fi->f", tri[:, 0], np.cross(tri[:, 1], tri[:, 2])).sum()
    if svol < 0:
        return Mesh(mesh.vertices, mesh.faces[:, ::-1])
    return mesh


def load_obj(path, scale: float = 1.0) -> Mesh:
    """Minimal Wavefront OBJ reader: ``v`` and ``f`` records, polygons fan
    triangulated, vertices scaled by ``scale``; the faces are reoriented to
    outward winding (``fix_winding``) so back-face culling stays exact."""
    verts, faces = [], []
    with open(path) as fh:
        for line in fh:
            if line.startswith("v "):
                parts = line.split()
                verts.append([float(parts[1]), float(parts[2]), float(parts[3])])
            elif line.startswith("f "):
                idx = [int(p.split("/")[0]) - 1 for p in line.split()[1:]]
                for i in range(1, len(idx) - 1):
                    faces.append([idx[0], idx[i], idx[i + 1]])
    return fix_winding(Mesh(np.asarray(verts, np.float32) * scale, np.asarray(faces, np.int32)))
