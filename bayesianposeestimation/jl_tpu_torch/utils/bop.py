"""BOP benchmark dataset I/O (host code, NumPy only).

Counterpart of ``jl_tpu/utils/bop.py``. Rows are plain dicts in lists (the
JAX package gathers the same dicts in pandas DataFrames), and images are
read by ``utils.png`` and ``utils.jpeg`` (the JAX package uses imageio), so
this module needs neither library.

Dataset layout (BOP toolkit convention)::

    <bop_dir>/<dataset>/<split>/<scene_id:06d>/
        scene_camera.json   # per image: cam_K (3x3 row-major), depth_scale
        scene_gt.json       # per image: [{obj_id, cam_R_m2c, cam_t_m2c(mm)}]
        scene_gt_info.json  # per image: [{bbox_visib, visib_fract, ...}]
        depth/<im_id:06d>.png        # uint16, value * depth_scale = mm
        rgb/<im_id:06d>.png|.jpg     # colour, where the set has it (or gray/)
        mask_visib/<im_id:06d>_<gt_id:06d>.png
    <bop_dir>/<dataset>/models/models_info.json   # diameter in mm
    <bop_dir>/<dataset>/models/obj_<obj_id:06d>.ply

All distances are converted to meters on load; invalid depth pixels are 0.
"""

from __future__ import annotations

import json
import struct
from pathlib import Path

import numpy as np

from ..camera import CvCamera
from . import mesh_io
from .jpeg import read_jpeg
from .png import png_size, read_png

__all__ = [
    "bop_test_or_train",
    "train_targets",
    "test_targets",
    "gt_targets",
    "gt_rows",
    "gt_info",
    "gt_dataframe",
    "gt_info_dataframe",
    "load_depth_image",
    "load_color_image",
    "load_mask_image",
    "load_segmentation",
    "load_mesh",
    "load_mesh_eval",
    "load_ply",
    "model_diameter",
    "depth_resize",
    "camera_for_row",
]

MM_TO_M = 1.0e-3


def _scene_dir(datasubset_path, scene_id) -> Path:
    return Path(datasubset_path) / f"{int(scene_id):06d}"


def _load_json(path):
    with open(path) as fh:
        return json.load(fh)


def gt_rows(datasubset_path, scene_id) -> list:
    """Ground-truth poses of one scene, one dict per annotation: scene_id,
    img_id, gt_id, obj_id, gt_t [m], gt_R [3, 3], cam_K [3, 3], depth_scale."""
    sdir = _scene_dir(datasubset_path, scene_id)
    gt = _load_json(sdir / "scene_gt.json")
    cams = _load_json(sdir / "scene_camera.json")
    rows = []
    for img_id, entries in gt.items():
        cam = cams[str(img_id)]
        K = np.asarray(cam["cam_K"], float).reshape(3, 3)
        for gt_id, e in enumerate(entries):
            rows.append(dict(
                scene_id=int(scene_id), img_id=int(img_id), gt_id=gt_id,
                obj_id=int(e["obj_id"]),
                gt_t=np.asarray(e["cam_t_m2c"], float) * MM_TO_M,
                gt_R=np.asarray(e["cam_R_m2c"], float).reshape(3, 3),
                cam_K=K, depth_scale=float(cam.get("depth_scale", 1.0))))
    return rows


def gt_info(datasubset_path, scene_id) -> list:
    """Visibility info of one scene, one dict per annotation."""
    info = _load_json(_scene_dir(datasubset_path, scene_id) / "scene_gt_info.json")
    return [dict(scene_id=int(scene_id), img_id=int(img_id), gt_id=gt_id,
                 visib_fract=float(e.get("visib_fract", 1.0)),
                 bbox_visib=e.get("bbox_visib"), bbox_obj=e.get("bbox_obj"))
            for img_id, entries in info.items() for gt_id, e in enumerate(entries)]


def train_targets(datasubset_path, scene_id) -> list:
    """Every annotation of a scene as an estimation target, joined with its
    visibility info on (scene_id, img_id, gt_id) (an inner join in the
    annotations' order) and tagged with ``datasubset_path``."""
    info = {(r["scene_id"], r["img_id"], r["gt_id"]): r
            for r in gt_info(datasubset_path, scene_id)}
    out = []
    for r in gt_rows(datasubset_path, scene_id):
        extra = info.get((r["scene_id"], r["img_id"], r["gt_id"]))
        if extra is not None:
            out.append({**r, **extra, "datasubset_path": str(datasubset_path)})
    return out


def test_targets(datasubset_path, scene_id, targets_json="test_targets_bop19.json") -> list:
    """Targets restricted to the official BOP19 test list beside the split."""
    targets = _load_json(Path(datasubset_path).parent / targets_json)
    wanted = {(int(t["scene_id"]), int(t["im_id"]), int(t["obj_id"]))
              for t in targets if int(t["scene_id"]) == int(scene_id)}
    return [r for r in train_targets(datasubset_path, scene_id)
            if (r["scene_id"], r["img_id"], r["obj_id"]) in wanted]


# the JAX package's DataFrame readers, as lists of the same row dicts
gt_dataframe = gt_rows
gt_info_dataframe = gt_info
gt_targets = train_targets


def bop_test_or_train(bop_dir, dataset, testset, scene_id) -> list:
    """The targets of a split: the BOP19 list for a test split, every
    annotation otherwise."""
    datasubset_path = Path(bop_dir) / dataset / testset
    if "test" in testset:
        return test_targets(datasubset_path, scene_id)
    return train_targets(datasubset_path, scene_id)


def load_depth_image(row, width=None, height=None):
    """Depth in meters, [H, W] float32, invalid = 0; optionally resized
    (nearest, invalid-preserving)."""
    sdir = _scene_dir(row["datasubset_path"], row["scene_id"])
    raw = read_png(sdir / "depth" / f"{int(row['img_id']):06d}.png").astype(np.float32)
    depth = raw * row.get("depth_scale", 1.0) * MM_TO_M
    if width is not None:
        depth = depth_resize(depth, width, height)
    return depth


def load_color_image(row, width=None, height=None):
    """The row's image from ``rgb/`` (else ``gray/``), ``.png`` before
    ``.jpg`` in each: [H, W, 3] (or [H, W] grayscale) as imageio reads it;
    optionally resized (nearest)."""
    sdir = _scene_dir(row["datasubset_path"], row["scene_id"])
    name = f"{int(row['img_id']):06d}"
    path = next((sdir / sub / f"{name}{ext}" for sub in ("rgb", "gray")
                 for ext in (".png", ".jpg") if (sdir / sub / f"{name}{ext}").exists()), None)
    if path is None:
        raise FileNotFoundError(f"no color image for {row['img_id']}")
    img = read_png(path) if path.suffix == ".png" else read_jpeg(path)
    if width is not None:
        img = depth_resize(img, width, height)
    return img


def load_mask_image(row, width=None, height=None):
    """Visible-surface mask of the row's annotation, bool [H, W]."""
    sdir = _scene_dir(row["datasubset_path"], row["scene_id"])
    p = sdir / "mask_visib" / f"{int(row['img_id']):06d}_{int(row['gt_id']):06d}.png"
    mask = read_png(p) > 0
    if width is not None:
        mask = depth_resize(mask.astype(np.float32), width, height) > 0.5
    return mask


def load_segmentation(row, width=None, height=None):
    """The visible mask stands in for a detector's segmentation on val/train."""
    return load_mask_image(row, width, height)


def depth_resize(img, width, height):
    """Nearest-neighbour resize that keeps invalid values exactly
    (interpolation would corrupt depth edges and invalid pixels)."""
    img = np.asarray(img)
    h, w = img.shape[:2]
    vi = (np.arange(height) * h // height).astype(int)
    ui = (np.arange(width) * w // width).astype(int)
    return img[vi][:, ui]


def camera_for_row(row, width=None, height=None, near=0.01, far=10.0) -> CvCamera:
    """CvCamera from the row's intrinsics at its depth image's size (read from
    the PNG header), optionally rescaled."""
    K = np.asarray(row["cam_K"], float).reshape(3, 3)
    sdir = _scene_dir(row["datasubset_path"], row["scene_id"])
    img_w, img_h = png_size(sdir / "depth" / f"{int(row['img_id']):06d}.png")
    cam = CvCamera(width=img_w, height=img_h, f_x=K[0, 0], f_y=K[1, 1], c_x=K[0, 2],
                   c_y=K[1, 2], s=K[0, 1], near=near, far=far)
    if width is not None:
        cam = cam.scale_to(width, height)
    return cam


_STRUCT_FMT = {"u1": "B", "u2": "H", "u4": "I", "i1": "b", "i2": "h", "i4": "i"}
_PLY_TYPES = {"float": "f4", "float32": "f4", "double": "f8", "uchar": "u1", "uint8": "u1",
              "int": "i4", "int32": "i4", "uint": "u4", "short": "i2", "ushort": "u2"}


def _parse_mixed_faces(buf: bytes, n_faces: int, count_np="u1", index_np="i4") -> np.ndarray:
    """Slow path: a polygon list of varying vertex counts, fan-triangulated."""
    faces = []
    off = 0
    count_fmt, count_size = _STRUCT_FMT[count_np], int(count_np[1])
    index_fmt, index_size = _STRUCT_FMT[index_np], int(index_np[1])
    for _ in range(n_faces):
        (k,) = struct.unpack_from("<" + count_fmt, buf, off)
        off += count_size
        idx = struct.unpack_from(f"<{k}{index_fmt}", buf, off)
        off += index_size * k
        for i in range(1, k - 1):
            faces.append([idx[0], idx[i], idx[i + 1]])
    return np.asarray(faces, np.int32)


def load_ply(path, scale=MM_TO_M) -> mesh_io.Mesh:
    """PLY reader (ascii and binary_little_endian) for BOP models; vertices
    are scaled from millimeters to meters by default. An all-triangle binary
    face list is read in one vectorised pass, anything else polygon by
    polygon and fan-triangulated."""
    with open(path, "rb") as fh:
        if fh.readline().strip() != b"ply":
            raise ValueError(f"not a PLY file: {path}")
        fmt = None
        n_verts = n_faces = 0
        vert_props = []
        face_list_types = ("uchar", "int")  # the BOP toolkit's default
        element = None
        while True:
            line = fh.readline().decode("ascii").strip()
            if line.startswith("format"):
                fmt = line.split()[1]
            elif line.startswith("element vertex"):
                n_verts, element = int(line.split()[-1]), "vertex"
            elif line.startswith("element face"):
                n_faces, element = int(line.split()[-1]), "face"
            elif line.startswith("element"):
                element = "other"
            elif line.startswith("property") and element == "vertex":
                parts = line.split()
                vert_props.append((parts[-1], parts[1]))
            elif line.startswith("property list") and element == "face":
                parts = line.split()
                face_list_types = (parts[2], parts[3])
            elif line == "end_header":
                break
        if fmt not in ("ascii", "binary_little_endian"):
            raise ValueError(f"unsupported PLY format {fmt!r} in {path}")
        if fmt == "ascii":
            verts = []
            for _ in range(n_verts):
                vals = fh.readline().split()
                verts.append([float(vals[0]), float(vals[1]), float(vals[2])])
            faces = []
            for _ in range(n_faces):
                vals = fh.readline().split()
                k = int(vals[0])
                idx = [int(v) for v in vals[1:1 + k]]
                for i in range(1, k - 1):
                    faces.append([idx[0], idx[i], idx[i + 1]])
            v = np.asarray(verts, np.float32)
            f = np.asarray(faces, np.int32)
        else:
            dtype = np.dtype([(name, "<" + _PLY_TYPES[t]) for name, t in vert_props])
            rec = np.frombuffer(fh.read(n_verts * dtype.itemsize), dtype=dtype, count=n_verts)
            v = np.stack([rec["x"], rec["y"], rec["z"]], axis=1).astype(np.float32)
            face_raw = fh.read()
            count_np = _PLY_TYPES[face_list_types[0]]
            index_np = _PLY_TYPES[face_list_types[1]]
            tri_dtype = np.dtype([("k", "<" + count_np), ("idx", "<" + index_np, (3,))])
            f = None
            if len(face_raw) >= n_faces * tri_dtype.itemsize:
                tris = np.frombuffer(face_raw, dtype=tri_dtype, count=n_faces)
                if np.all(tris["k"] == 3):
                    f = np.ascontiguousarray(tris["idx"]).astype(np.int32)
            if f is None:
                f = _parse_mixed_faces(face_raw, n_faces, count_np, index_np)
    return mesh_io.Mesh(v * scale, f)


def load_mesh(row_or_path, models_dir=None, decimate_to=None) -> mesh_io.Mesh:
    """Object mesh of a target row (or a PLY path), outward-wound (the
    renderer culls back faces), optionally decimated to ``decimate_to``
    triangles."""
    if isinstance(row_or_path, (str, Path)):
        path = Path(row_or_path)
    else:
        row = row_or_path
        base = Path(row["datasubset_path"]).parent / "models"
        if models_dir is not None:
            base = Path(models_dir)
        path = base / f"obj_{int(row['obj_id']):06d}.ply"
    mesh = mesh_io.fix_winding(load_ply(path))
    if decimate_to is not None and mesh.n_faces > decimate_to:
        from .decimate import decimate

        mesh = decimate(mesh, decimate_to)
    return mesh


# the mesh the evaluation renders (the JAX package's name)
load_mesh_eval = load_mesh


def model_diameter(row_or_models_info, obj_id=None):
    """Object diameter in meters from models_info.json (of a row's dataset,
    or at the given path for ``obj_id``)."""
    if obj_id is None:
        row = row_or_models_info
        info_path = Path(row["datasubset_path"]).parent / "models" / "models_info.json"
        obj_id = int(row["obj_id"])
    else:
        info_path = Path(row_or_models_info)
    return float(_load_json(info_path)[str(obj_id)]["diameter"]) * MM_TO_M
