"""Writes the benchmark's frozen inputs (run once, when the benchmark was
defined; the benchmark itself only reads what this wrote):

* ``data/meshes/synthcad_obj_<id>_<faces>.npz``: each synthcad CAD model,
  outward-wound and decimated by the port's quadric decimator to the
  triangle budget of a 30x30 (1,800 faces) and a 100x100 (20,000) crop;
* ``data/meshes/monkey_0.18.npz``: the tracking script's 0.18 m monkey, and
  ``monkey_0.18_256.npz``, its 256-face decimation the tracker runs on;
* ``data/synthcad_val.sha256.json``: the hash of every file of synthcad val
  scenes 1-6 and of the models' info, which the benchmark reads.

    python portbench/tools/make_inputs.py
"""

import hashlib
import json
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(REPO))

from bayesianposeestimation.jl_tpu_torch.utils import bop, mesh_io  # noqa: E402
from bayesianposeestimation.jl_tpu_torch.utils.decimate import (  # noqa: E402
    decimate,
    triangle_budget_for_resolution,
)

OUT = REPO / "portbench" / "data"
SCENES = range(1, 7)


def save(name, mesh):
    np.savez_compressed(OUT / "meshes" / name, vertices=np.asarray(mesh.vertices, np.float32),
                        faces=np.asarray(mesh.faces, np.int32))
    print(name, mesh.n_vertices, mesh.n_faces)


def main():
    (OUT / "meshes").mkdir(parents=True, exist_ok=True)
    models = REPO / "data" / "bop" / "synthcad" / "models"
    for obj in (1, 2, 3):
        for side in (30, 100):
            budget = triangle_budget_for_resolution(side, side)
            mesh = bop.load_mesh(models / f"obj_{obj:06d}.ply", decimate_to=budget)
            save(f"synthcad_obj_{obj}_{budget}.npz", mesh)
    monkey = mesh_io.monkey_mesh(0.18)
    save("monkey_0.18.npz", monkey)
    save("monkey_0.18_256.npz", decimate(monkey, 256))
    root = REPO / "data" / "bop" / "synthcad"
    files = ["models/models_info.json"]
    for s in SCENES:
        sdir = root / "val" / f"{s:06d}"
        files += sorted(str(p.relative_to(root)) for p in sdir.rglob("*") if p.is_file())
    hashes = {f: hashlib.sha256((root / f).read_bytes()).hexdigest() for f in files}
    (OUT / "synthcad_val.sha256.json").write_text(json.dumps(
        {"root": "data/bop/synthcad", "files": hashes}, indent=0, sort_keys=True) + "\n")
    print(len(hashes), "files hashed")


if __name__ == "__main__":
    main()
