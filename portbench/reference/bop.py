"""The BOP scenes as the benchmark reads them (a frozen copy of the BOP
reader's conventions): ground truths, intrinsics, depth in metres (invalid
0), visible masks and model diameters.

Every file is read through ``Frozen``, which holds it to the SHA-256 that
the benchmark's manifest recorded, so a change to the checked-in data set
stops the run instead of moving the yardstick.
"""

from __future__ import annotations

import hashlib
import json
from pathlib import Path

import numpy as np

from .png import read_gray_png

MM_TO_M = 1.0e-3


class Frozen:
    """Reads files under ``root`` (a data set directory of the checkout) that
    the manifest at ``manifest`` lists, each held to its recorded hash."""

    def __init__(self, repo: Path, manifest: Path):
        spec = json.loads(Path(manifest).read_text())
        self.root = Path(repo) / spec["root"]
        self.hashes = spec["files"]

    def read(self, rel: str) -> bytes:
        if rel not in self.hashes:
            raise KeyError(f"{rel} is not in the benchmark's manifest")
        data = (self.root / rel).read_bytes()
        got = hashlib.sha256(data).hexdigest()
        if got != self.hashes[rel]:
            raise ValueError(f"{self.root / rel} changed: sha256 {got}, the benchmark "
                             f"froze {self.hashes[rel]}")
        return data

    def json(self, rel):
        return json.loads(self.read(rel))


def scene_rows(frozen: Frozen, split: str, scene_id: int) -> list:
    """The annotations of one scene in file order: scene_id, img_id, gt_id,
    obj_id, gt_t [m], gt_R [3, 3], K [3, 3], depth_scale, visib_fract."""
    sdir = f"{split}/{scene_id:06d}"
    gt = frozen.json(f"{sdir}/scene_gt.json")
    cams = frozen.json(f"{sdir}/scene_camera.json")
    info = frozen.json(f"{sdir}/scene_gt_info.json")
    rows = []
    for img_id, entries in gt.items():
        cam = cams[str(img_id)]
        for gt_id, e in enumerate(entries):
            rows.append(dict(
                scene_id=int(scene_id), img_id=int(img_id), gt_id=gt_id,
                obj_id=int(e["obj_id"]),
                gt_t=np.asarray(e["cam_t_m2c"], float) * MM_TO_M,
                gt_R=np.asarray(e["cam_R_m2c"], float).reshape(3, 3),
                K=np.asarray(cam["cam_K"], float).reshape(3, 3),
                depth_scale=float(cam.get("depth_scale", 1.0)),
                visib_fract=float(info[str(img_id)][gt_id].get("visib_fract", 1.0))))
    return rows


def depth_image(frozen: Frozen, split, scene_id, img_id, depth_scale) -> np.ndarray:
    """Depth in metres, [H, W] float32, invalid 0."""
    raw = read_gray_png(frozen.read(f"{split}/{scene_id:06d}/depth/{img_id:06d}.png"))
    return raw.astype(np.float32) * depth_scale * MM_TO_M


def mask_image(frozen: Frozen, split, scene_id, img_id, gt_id) -> np.ndarray:
    """The annotation's visible-surface mask, bool [H, W]."""
    rel = f"{split}/{scene_id:06d}/mask_visib/{img_id:06d}_{gt_id:06d}.png"
    return read_gray_png(frozen.read(rel)) > 0


def diameters(frozen: Frozen) -> dict:
    """Object diameter in metres by obj_id."""
    return {int(k): float(v["diameter"]) * MM_TO_M
            for k, v in frozen.json("models/models_info.json").items()}
