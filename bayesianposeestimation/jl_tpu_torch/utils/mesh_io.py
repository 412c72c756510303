"""Procedural meshes and mesh files (host-side NumPy).

A copy of ``jl_tpu/utils/mesh_io.py``: ``Mesh``, the cube, icosphere and
"monkey" blob generators, the CAD-scale generators of the synthetic BOP set
(``subdivide_mesh``, ``displaced_icosphere``, ``lathe_mesh``,
``torus_mesh``), ``mesh_diameter``, ``fix_winding``, the Wavefront OBJ
reader ``load_obj`` and the writers ``save_obj`` and ``save_ply``; the port
keeps its own copy rather than importing the JAX package. Devices only ever
see dense ``(verts, faces)`` tensors.
"""

from __future__ import annotations

import os

import numpy as np

__all__ = ["Mesh", "cube_mesh", "icosphere_mesh", "monkey_mesh", "mesh_diameter", "fix_winding",
           "load_obj", "save_obj", "save_ply", "subdivide_mesh", "displaced_icosphere",
           "lathe_mesh", "torus_mesh"]


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

    def scaled(self, s: float) -> "Mesh":
        return Mesh(self.vertices * s, self.faces)

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


def save_obj(path, mesh: Mesh):
    """Write ``mesh`` as a Wavefront OBJ file (vertices to 6 decimals), byte
    for byte as the JAX package's writer does, its header comment included."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as fh:
        fh.write("# generated by bayesianposeestimation.jl_tpu\n")
        for v in mesh.vertices:
            fh.write(f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n")
        for f in mesh.faces:
            fh.write(f"f {f[0] + 1} {f[1] + 1} {f[2] + 1}\n")


def save_ply(path, mesh: Mesh, binary: bool = True):
    """Write a PLY file in the BOP convention (float32 xyz vertices, uchar +
    3x int32 face lists): ``binary`` (default) as binary_little_endian, the
    format real BOP models ship in, else ASCII with vertices to 6 decimals.
    Units are whatever the caller put in ``mesh`` (BOP models are
    millimeters)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fmt = "binary_little_endian" if binary else "ascii"
    header = (
        f"ply\nformat {fmt} 1.0\n"
        f"element vertex {mesh.n_vertices}\n"
        "property float x\nproperty float y\nproperty float z\n"
        f"element face {mesh.n_faces}\n"
        "property list uchar int vertex_indices\nend_header\n"
    )
    if binary:
        v = np.ascontiguousarray(mesh.vertices, "<f4")
        f_rec = np.empty(mesh.n_faces, np.dtype([("k", "u1"), ("idx", "<i4", (3,))]))
        f_rec["k"] = 3
        f_rec["idx"] = mesh.faces
        with open(path, "wb") as fh:
            fh.write(header.encode("ascii"))
            fh.write(v.tobytes())
            fh.write(f_rec.tobytes())
    else:
        with open(path, "w") as fh:
            fh.write(header)
            for v in mesh.vertices:
                fh.write(f"{v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n")
            for f in mesh.faces:
                fh.write(f"3 {f[0]} {f[1]} {f[2]}\n")


def subdivide_mesh(mesh: Mesh, levels: int = 1, project_unit: bool = False) -> Mesh:
    """Loop-topology midpoint subdivision (4x faces per level), vectorized:
    shared edges are deduplicated with one np.unique per level.
    ``project_unit`` renormalizes new vertices to the unit sphere
    (icosphere refinement)."""
    v = mesh.vertices.astype(np.float64)
    f = mesh.faces.astype(np.int64)
    for _ in range(levels):
        n_f = f.shape[0]
        edges = np.concatenate([f[:, [0, 1]], f[:, [1, 2]], f[:, [2, 0]]])
        uniq, inv = np.unique(np.sort(edges, axis=1), axis=0, return_inverse=True)
        mid = (v[uniq[:, 0]] + v[uniq[:, 1]]) / 2.0
        if project_unit:
            mid /= np.linalg.norm(mid, axis=1, keepdims=True)
        m01, m12, m20 = (len(v) + inv[:n_f], len(v) + inv[n_f:2 * n_f],
                         len(v) + inv[2 * n_f:])
        a, b, c = f[:, 0], f[:, 1], f[:, 2]
        f = np.concatenate([
            np.stack([a, m01, m20], 1), np.stack([b, m12, m01], 1),
            np.stack([c, m20, m12], 1), np.stack([m01, m12, m20], 1)])
        v = np.concatenate([v, mid])
    return Mesh(v.astype(np.float32), f.astype(np.int32))


def _harmonic_field(p: np.ndarray, seed: int, octaves: int = 4,
                    base_freq: float = 2.0) -> np.ndarray:
    """Smooth deterministic scalar noise on points [N, 3]: a sum of random
    plane waves with geometrically increasing frequency and decaying
    amplitude. Values roughly in [-1, 1]."""
    rng = np.random.default_rng(seed)
    out = np.zeros(p.shape[0])
    total = 0.0
    for o in range(octaves):
        amp = 0.55 ** o
        for _ in range(3):
            k = rng.normal(size=3)
            k *= base_freq * 2.0 ** o / np.linalg.norm(k)
            out += amp * np.sin(p @ k + rng.uniform(0, 2 * np.pi))
            total += amp
    return out / total


def displaced_icosphere(radius: float, subdivisions: int, seed: int = 0,
                        amp: float = 0.18) -> Mesh:
    """Organic CAD-scale model: an icosphere (20 * 4^n faces; n = 6 ->
    81,920) displaced radially by a multi-octave harmonic field. Watertight,
    consistently wound, non-convex, like a scanned BOP model."""
    base = icosphere_mesh(1.0, min(subdivisions, 4))
    extra = subdivisions - min(subdivisions, 4)
    if extra:
        base = subdivide_mesh(base, extra, project_unit=True)
    v = base.vertices.astype(np.float64)
    r = 1.0 + amp * _harmonic_field(v, seed)
    return Mesh((v * r[:, None] * radius).astype(np.float32), base.faces)


def lathe_mesh(radius_of_z, z_lo: float, z_hi: float, n_profile: int = 160,
               n_seg: int = 400) -> Mesh:
    """Machined-part CAD mesh: the profile ``radius_of_z(z)`` (vector in ->
    vector out, radii > 0) revolved around the z axis, with centre-fan caps.
    Faces: 2 * n_seg * (n_profile - 1) + 2 * n_seg (n_profile = 160,
    n_seg = 400 -> 128,000). Outward winding."""
    zs = np.linspace(z_lo, z_hi, n_profile)
    rs = np.asarray(radius_of_z(zs), np.float64)
    ang = np.arange(n_seg) * (2 * np.pi / n_seg)
    cos, sin = np.cos(ang), np.sin(ang)
    # ring-major vertex grid [n_profile, n_seg]
    vx = rs[:, None] * cos[None, :]
    vy = rs[:, None] * sin[None, :]
    vz = np.broadcast_to(zs[:, None], vx.shape)
    verts = np.stack([vx, vy, vz], axis=-1).reshape(-1, 3)
    idx = np.arange(n_profile * n_seg).reshape(n_profile, n_seg)
    nxt = np.roll(idx, -1, axis=1)
    a, b = idx[:-1].ravel(), nxt[:-1].ravel()
    c, d = idx[1:].ravel(), nxt[1:].ravel()
    # each quad (a, b, d, c) split in two; fix_winding settles the orientation
    side = np.concatenate([np.stack([a, b, d], 1), np.stack([a, d, c], 1)])
    bot_center = len(verts)
    top_center = len(verts) + 1
    verts = np.concatenate([verts, [[0, 0, z_lo], [0, 0, z_hi]]])
    bot = np.stack([np.full(n_seg, bot_center), nxt[0], idx[0]], 1)
    top = np.stack([np.full(n_seg, top_center), idx[-1], nxt[-1]], 1)
    faces = np.concatenate([side, bot, top]).astype(np.int32)
    return fix_winding(Mesh(verts.astype(np.float32), faces))


def torus_mesh(major_radius: float, minor_radius: float, n_major: int = 320,
               n_minor: int = 160) -> Mesh:
    """Torus (2 * n_major * n_minor faces; defaults -> 102,400), symmetric
    about z: a pose target whose metric must handle the symmetry (ADD-S and
    VSD do)."""
    u = np.arange(n_major) * (2 * np.pi / n_major)
    v = np.arange(n_minor) * (2 * np.pi / n_minor)
    cu, su = np.cos(u)[:, None], np.sin(u)[:, None]
    cv, sv = np.cos(v)[None, :], np.sin(v)[None, :]
    ring = major_radius + minor_radius * cv
    verts = np.stack([ring * cu, ring * su,
                      np.broadcast_to(minor_radius * sv, (n_major, n_minor))],
                     axis=-1).reshape(-1, 3)
    idx = np.arange(n_major * n_minor).reshape(n_major, n_minor)
    iu = np.roll(idx, -1, axis=0)
    iv = np.roll(idx, -1, axis=1)
    iuv = np.roll(iu, -1, axis=1)
    a, b, c, d = idx.ravel(), iu.ravel(), iv.ravel(), iuv.ravel()
    faces = np.concatenate([np.stack([a, b, d], 1),
                            np.stack([a, d, c], 1)]).astype(np.int32)
    return fix_winding(Mesh(verts.astype(np.float32), faces))
