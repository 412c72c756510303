"""BOP pose requests: every ground truth of the named scenes of a split, in
a permutation drawn from the seed and cycled by one client that sends the
next request when the last estimate is back (a closed loop).

The scene files are read through the benchmark's frozen reader
(``reference.bop``) and decoded here, before the window: BOP's timing rule
starts a pose's clock after its image, camera and model are loaded. A
request carries the decoded depth [H, W] (metres, invalid 0), the
annotation's visible mask, the intrinsics, the object's id and diameter."""

from __future__ import annotations

import functools
from pathlib import Path

import numpy as np

from ..reference import bop


def load(traffic: dict, repo: Path, seed: int):
    """The requests, in the seed's order."""
    items = _decoded(str(repo), traffic["manifest"], traffic["split"], tuple(traffic["scenes"]))
    if len(items) != traffic["n_requests"]:
        raise ValueError(f"the scenes hold {len(items)} ground truths, the cell names "
                         f"{traffic['n_requests']}")
    order = np.random.default_rng([seed, 1]).permutation(len(items))
    return [items[i] for i in order]


@functools.lru_cache(maxsize=2)
def _decoded(repo, manifest, split, scenes):
    """Every ground truth of ``scenes`` with its decoded image and mask (kept
    for another seed in the same process; never written anywhere)."""
    repo = Path(repo)
    frozen = bop.Frozen(repo, repo / "portbench" / manifest)
    diam = bop.diameters(frozen)
    images, items = {}, []
    for scene in scenes:
        for row in bop.scene_rows(frozen, split, scene):
            key = (row["scene_id"], row["img_id"])
            if key not in images:
                images[key] = bop.depth_image(frozen, split, *key, row["depth_scale"])
            items.append(dict(row=row, depth=images[key],
                              mask=bop.mask_image(frozen, split, *key, row["gt_id"]),
                              K=row["K"], obj_id=row["obj_id"], diameter=diam[row["obj_id"]]))
    return items
