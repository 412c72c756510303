"""Generate synthetic BOP-format datasets through the PyTorch/CUDA port
(counterpart of ``scripts/make_synthetic_bop.py``): ground-truth poses of
procedural meshes rendered into BOP-convention scene directories
(scene_gt.json, scene_gt_info.json, scene_camera.json, depth/, mask_visib/,
models/).

Three profiles, with the JAX script's arguments and semantics:

* ``easy`` (dataset ``synth``): three <= 1,280-face meshes, an optional second
  occluding instance on even images, clean depth + noise over a flat 1.5 m
  background.
* ``cad`` (dataset ``synthcad``): 81,920 / 128,000 / 102,400-face models
  written as binary PLY (millimetres), unannotated low-poly clutter in front
  of the targets, a structured tabletop background and Kinect-style sensor
  artifacts (axial noise, silhouette dropout, speckle holes, 1 mm steps).
* ``hard`` (split ``hard``): a sphere behind a sphere, the rear one moved
  sideways until its visible fraction is nearest the image's target.

Every object and clutter instance is rendered alone by the depth-only kernel
(``ops/cuda_raster.render_depth``) into a 160x160 window of the 640x480
frame around its projection, one pose per launch, then composited. The
NumPy draws (translations, clutter, background, noise) come from
``np.random.default_rng(--seed)`` in the JAX script's order, so at the same
seed they equal its draws; rotations are ``quaternions.rand_quaternion`` on a
CPU ``torch.Generator`` seeded with --seed (the JAX script draws them from
``jax.random``, which torch does not reproduce).

    python scripts/torch_make_synthetic_bop.py                  # easy
    python scripts/torch_make_synthetic_bop.py --profile cad --n-scenes 4

The default --root is data/bop_cuda, beside the JAX package's data/bop.
Runs on the CUDA device unless ``--device cpu`` is given (the kernel's plain
version; the cad models are too large for it).
"""

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402
import torch  # noqa: E402

# Solo-render window (px): big enough for every object at its nearest
# sampled distance.
WINDOW = 160


def build_objects(profile):
    from bayesianposeestimation.jl_tpu_torch.utils import mesh_io

    if profile in ("easy", "hard"):
        return {
            1: mesh_io.monkey_mesh(0.08),
            2: mesh_io.cube_mesh(0.08),
            3: mesh_io.icosphere_mesh(0.04, 2),
        }

    def shaft_profile(z):
        # machined shaft: steps + thread-like grooves + a collar
        r = 0.028 + 0.006 * np.sin(40 * np.pi * z)
        r = r + np.where(np.abs(z) < 0.02, 0.008, 0.0)
        return np.clip(r, 0.008, None)

    return {
        1: mesh_io.displaced_icosphere(0.05, 6, seed=1),     # 81,920 faces
        2: mesh_io.lathe_mesh(shaft_profile, -0.06, 0.06),   # 128,000 faces
        3: mesh_io.torus_mesh(0.045, 0.016),                 # 102,400 faces
    }


def make_clutter_library(rng):
    """Unannotated distractor meshes, not in models/: the likelihood must
    reject their depth instead of latching onto it."""
    from bayesianposeestimation.jl_tpu_torch.utils import mesh_io

    lib = []
    for i in range(6):
        kind = i % 3
        s = rng.uniform(0.04, 0.09)
        if kind == 0:
            lib.append(mesh_io.cube_mesh(s))
        elif kind == 1:
            lib.append(mesh_io.icosphere_mesh(s / 2, 2))
        else:
            lib.append(mesh_io.monkey_mesh(s))
    return lib


def window_origin(cam, t):
    """Top-left corner of the WINDOW x WINDOW sub-image centred on the
    projection of t, clamped inside the frame."""
    u = cam.f_x * t[0] / t[2] + cam.c_x
    v = cam.f_y * t[1] / t[2] + cam.c_y
    x0 = int(np.clip(round(u - WINDOW / 2), 0, cam.width - WINDOW))
    y0 = int(np.clip(round(v - WINDOW / 2), 0, cam.height - WINDOW))
    return x0, y0


def window_camera(cam, x0, y0):
    """The full camera with its principal point moved by the window origin:
    the same pixel grid, WINDOW x WINDOW pixels of it."""
    from dataclasses import replace

    return replace(cam, width=WINDOW, height=WINDOW, c_x=cam.c_x - x0, c_y=cam.c_y - y0)


def render_solo(mesh_dev, cam, t, q, x0, y0):
    """Full-frame solo depth (np.inf = background), rendered by the
    depth-only kernel inside the window only (one pose, one launch)."""
    from bayesianposeestimation.jl_tpu_torch.ops.cuda_raster import render_depth

    verts, faces = mesh_dev
    dev = verts.device
    win = render_depth(verts, faces, window_camera(cam, x0, y0),
                       torch.as_tensor(np.asarray(t, np.float32)[None], device=dev),
                       torch.as_tensor(np.asarray(q, np.float32)[None], device=dev),
                       device=dev)[0].cpu().numpy()
    full = np.full((cam.height, cam.width), np.inf, np.float32)
    full[y0:y0 + WINDOW, x0:x0 + WINDOW] = np.where(win > 0, win, np.inf)
    return full


def background_depth(cam, rng, base_t, diam):
    """Structured background: a tilted support plane just behind the object
    cluster plus a far wall, with low-frequency height variation, so that
    near the silhouette the background lies within ~0.1-0.3 m of the object."""
    uu, vv = np.meshgrid(np.arange(cam.width), np.arange(cam.height))
    dx = (uu - cam.c_x) / cam.f_x
    dy = (vv - cam.c_y) / cam.f_y
    # plane through a point slightly below/behind the cluster, tilted like a
    # table seen from a shoulder camera (depth grows toward the image top)
    p0 = np.asarray(base_t) + np.asarray([0.0, 0.05, 0.35 * diam + 0.05])
    n = np.asarray([rng.uniform(-0.15, 0.15), -1.0, rng.uniform(-0.45, -0.25)])
    n /= np.linalg.norm(n)
    d = n @ p0
    denom = n[0] * dx + n[1] * dy + n[2]
    z_plane = np.where(np.sign(denom) == np.sign(d), d / denom, np.inf)
    z_plane = np.where(z_plane > 0.3, z_plane, np.inf)
    # far wall behind the table horizon
    bg = np.minimum(z_plane, base_t[2] + 0.9)
    # low-frequency surface variation (boxes/cloth on the table)
    wobble = np.zeros_like(bg)
    for _ in range(6):
        fu, fv = rng.uniform(1.5, 8, 2)
        ph = rng.uniform(0, 2 * np.pi, 2)
        wobble += rng.uniform(0.002, 0.012) * np.sin(
            fu * dx * 3 + ph[0]) * np.sin(fv * dy * 3 + ph[1])
    return (bg + wobble).astype(np.float32)


def apply_sensor_artifacts(depth, rng):
    """Kinect-style degradation: depth-dependent axial noise, dropout at
    silhouette / steep-gradient pixels, random speckle holes. 0 = invalid;
    the 1 mm quantization happens when the PNG is written."""
    z = depth.copy()
    valid = z > 0
    # axial noise grows quadratically with distance (structured-light model)
    sigma = 0.0012 + 0.0019 * np.maximum(z - 0.4, 0.0) ** 2
    z = np.where(valid, z + rng.normal(0, 1, z.shape) * sigma, 0.0)
    # silhouette dropout: strong local depth discontinuities shadow the
    # projector -> invalid pixels along object edges (dilated 1 px)
    gy, gx = np.gradient(np.where(valid, z, np.nan))
    grad = np.maximum(np.abs(gx), np.abs(gy))
    edge = ~np.isfinite(grad) | (grad > 0.02)
    edge = edge & valid
    grow = edge.copy()
    grow[1:] |= edge[:-1]
    grow[:-1] |= edge[1:]
    grow[:, 1:] |= edge[:, :-1]
    grow[:, :-1] |= edge[:, 1:]
    drop = grow & (rng.random(z.shape) < 0.8)
    z = np.where(drop, 0.0, z)
    # speckle holes: small disks of missing returns (shiny/absorbing spots)
    uu, vv = np.meshgrid(np.arange(z.shape[1]), np.arange(z.shape[0]))
    for _ in range(40):
        cx, cy = rng.uniform(0, z.shape[1]), rng.uniform(0, z.shape[0])
        r = rng.uniform(1.0, 3.5)
        z[(uu - cx) ** 2 + (vv - cy) ** 2 < r * r] = 0.0
    return z


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--root", default="data/bop_cuda")
    ap.add_argument("--profile", choices=["easy", "cad", "hard"], default="easy",
                    help="hard: sphere behind sphere at visib ~0.45, where the rear "
                         "instance's posterior prefers the occluder's mode")
    ap.add_argument("--dataset", default=None,
                    help="default: synth (easy/hard) / synthcad (cad)")
    ap.add_argument("--split", default=None)
    ap.add_argument("--n-scenes", type=int, default=None)
    ap.add_argument("--n-images", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--scene-offset", type=int, default=0,
                    help="first scene id minus 1: append scenes to an existing split "
                         "(pass a fresh --seed or the new scenes repeat the old draws)")
    ap.add_argument("--visib-targets", type=float, nargs="+", default=[0.45],
                    help="hard profile: per-image target visibility of the rear "
                         "instance, cycled over images")
    ap.add_argument("--multi-instance", action=argparse.BooleanOptionalAction, default=True,
                    help="two partially-occluding instances on even images")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    hard = args.profile == "hard"
    if args.dataset is None:
        args.dataset = "synthcad" if args.profile == "cad" else "synth"
    if args.split is None:
        args.split = "hard" if hard else "val"
    if args.n_scenes is None:
        args.n_scenes = {"easy": 1, "cad": 4, "hard": 1}[args.profile]
    if args.n_images is None:
        args.n_images = {"easy": 8, "cad": 12, "hard": 6}[args.profile]
    return args


def quaternion_source(seed):
    """The generator's rotations: uniform unit quaternions [4] (w, x, y, z),
    one per call, from a CPU ``torch.Generator`` seeded with ``seed``."""
    from bayesianposeestimation.jl_tpu_torch.quaternions import rand_quaternion

    gen = torch.Generator().manual_seed(seed)
    return lambda: rand_quaternion(gen).numpy()


def generate(args, draw_quaternion=None):
    """Write the dataset ``args`` (``parse_args``) describes. Rotations come
    from ``draw_quaternion() -> [4]`` in the JAX script's order (per image:
    the instances, then the clutter), by default ``quaternion_source(
    args.seed)``. Returns a summary: the split directory, the seconds per
    image and the render_depth calls."""
    from bayesianposeestimation.jl_tpu_torch import quaternions as quat
    from bayesianposeestimation.jl_tpu_torch.camera import CvCamera
    from bayesianposeestimation.jl_tpu_torch.devices import resolve_device
    from bayesianposeestimation.jl_tpu_torch.ops.cuda_raster import mesh_tensors
    from bayesianposeestimation.jl_tpu_torch.utils import mesh_io
    from bayesianposeestimation.jl_tpu_torch.utils.png import write_png

    dev = resolve_device(args.device)
    if draw_quaternion is None:
        draw_quaternion = quaternion_source(args.seed)
    hard = args.profile == "hard"
    cad = args.profile == "cad"
    root = Path(args.root) / args.dataset
    split_dir = root / args.split
    models_dir = root / "models"
    models_dir.mkdir(parents=True, exist_ok=True)

    # VGA with Kinect-like intrinsics: objects of ~0.1 m at 0.8-1.2 m span
    # 50-80 px, as in the BOP datasets (lm / tless are 640x480)
    cam = CvCamera(width=640, height=480, f_x=580.0, f_y=580.0, c_x=319.5, c_y=239.5,
                   near=0.01, far=10.0)
    K = [cam.f_x, 0.0, cam.c_x, 0.0, cam.f_y, cam.c_y, 0.0, 0.0, 1.0]
    depth_scale = 1.0 if cad else 0.1  # mm per png unit (cad: 1 mm quantization)

    objects = build_objects(args.profile)
    models_info = {}
    for obj_id, mesh in objects.items():
        # BOP models are in millimetres; the cad profile writes binary PLY
        mm = mesh_io.Mesh(mesh.vertices * 1000.0, mesh.faces)
        mesh_io.save_ply(str(models_dir / f"obj_{obj_id:06d}.ply"), mm, binary=cad)
        models_info[str(obj_id)] = {"diameter": mesh_io.mesh_diameter(mesh) * 1000.0}
    (models_dir / "models_info.json").write_text(json.dumps(models_info))
    print({k: f"{objects[int(k)].n_faces} faces" for k in models_info})

    rng = np.random.default_rng(args.seed)
    clutter_lib = make_clutter_library(rng) if cad else []
    dev_meshes = {oid: mesh_tensors(m.vertices, m.faces, dev) for oid, m in objects.items()}
    clutter_dev = [mesh_tensors(m.vertices, m.faces, dev) for m in clutter_lib]

    targets, seconds, renders = [], [], 0
    for scene_id in range(args.scene_offset + 1, args.scene_offset + args.n_scenes + 1):
        sdir = split_dir / f"{scene_id:06d}"
        (sdir / "depth").mkdir(parents=True, exist_ok=True)
        (sdir / "mask_visib").mkdir(exist_ok=True)
        cams, gts, infos = {}, {}, {}
        for img_id in range(args.n_images):
            t_img = time.perf_counter()
            if hard:
                obj_id = 3  # the icosphere: both modes are rotationally alike
            else:
                obj_id = 1 + (img_id % len(objects))
            diam = float(models_info[str(obj_id)]["diameter"]) / 1000.0
            n_inst = 2 if (hard or (args.multi_instance and img_id % 2 == 0)) else 1
            inst_t, inst_q = [], []
            base_t = np.asarray([rng.uniform(-0.05, 0.05), rng.uniform(-0.04, 0.04),
                                 rng.uniform(0.8, 1.2)])
            for i in range(n_inst):
                inst_q.append(np.asarray(draw_quaternion(), np.float32))
                if i == 0:
                    inst_t.append(base_t)
                elif hard:
                    inst_t.append(None)  # placed by the visibility search below
                else:
                    # behind + laterally shifted by ~40% of the object extent
                    # -> partial occlusion of the rear instance
                    off = np.asarray([rng.choice([-1, 1]) * 0.4 * diam,
                                      rng.uniform(-0.1, 0.1) * diam,
                                      rng.uniform(0.3, 0.6) * diam])
                    inst_t.append(base_t + off)

            def solo(t, q):
                nonlocal renders
                renders += 1
                x0, y0 = window_origin(cam, t)
                return render_solo(dev_meshes[obj_id], cam, t, q, x0, y0)

            if hard:
                # the lateral offset of the rear sphere whose visibility lands
                # nearest this image's target
                target_visib = args.visib_targets[img_id % len(args.visib_targets)]
                front = solo(inst_t[0], inst_q[0])
                side = rng.choice([-1, 1])
                behind = 0.45 * diam
                best = None
                for lat in np.arange(0.02, 0.64, 0.04):
                    t_rear = base_t + np.asarray([side * lat * diam, 0.0, behind])
                    rear = solo(t_rear, inst_q[1])
                    rendered = np.isfinite(rear)
                    vis = rendered & (rear <= np.minimum(front, rear) + 1e-3)
                    visib = vis.sum() / max(rendered.sum(), 1)
                    if best is None or abs(visib - target_visib) < abs(best[0] - target_visib):
                        best = (visib, t_rear, rear)
                inst_t[1] = best[1]
                solos = [front, best[2]]
            else:
                solos = [solo(t, q) for t, q in zip(inst_t, inst_q)]

            # unannotated clutter in front of the target cluster, clipping its
            # silhouette (cad profile only)
            clutter_solos = []
            if cad:
                for _ in range(rng.integers(2, 5)):
                    ci = int(rng.integers(0, len(clutter_lib)))
                    cdiam = mesh_io.mesh_diameter(clutter_lib[ci])
                    side = rng.choice([-1, 1])
                    off = np.asarray([
                        side * rng.uniform(0.35, 0.7) * (diam + cdiam) / 2,
                        rng.uniform(-0.4, 0.6) * diam,
                        -rng.uniform(0.12, 0.3)])
                    ct = base_t + off
                    cq = np.asarray(draw_quaternion(), np.float32)
                    x0, y0 = window_origin(cam, ct)
                    renders += 1
                    clutter_solos.append(render_solo(clutter_dev[ci], cam, ct, cq, x0, y0))

            obj_stack = np.stack(solos + clutter_solos)  # inf = background
            obj_min = obj_stack.min(0)

            if cad:
                bg = background_depth(cam, rng, base_t, diam)
                # objects composite over the background, so that visib_fract
                # counts object occlusion only
                composite = np.where(np.isfinite(obj_min), obj_min, bg)
                noisy = apply_sensor_artifacts(
                    np.where(np.isfinite(composite), composite, 0.0), rng)
            else:
                depth = np.where(np.isfinite(obj_min), obj_min, 0.0)
                noise = rng.normal(0, 0.003, depth.shape)
                noisy = np.where(depth > 0, depth + noise, 0.0)
                # background plane at 1.5 m
                noisy = np.where(noisy == 0, 1.5 + rng.normal(0, 0.003, depth.shape), noisy)
            png = np.clip(noisy * 1000.0 / depth_scale, 0, 65535).astype(np.uint16)
            write_png(sdir / "depth" / f"{img_id:06d}.png", png)

            gt_list, info_list = [], []
            for gt_id, (t, q, solo_d) in enumerate(zip(inst_t, inst_q, solos)):
                # visible = this instance wins the object z-buffer (1 mm tol);
                # occlusion counts objects (clutter included), not background
                rendered = np.isfinite(solo_d)
                visible = rendered & (solo_d <= obj_min + 1e-3)
                visib_fract = float(visible.sum() / max(rendered.sum(), 1))
                mask = visible.astype(np.uint8) * 255
                write_png(sdir / "mask_visib" / f"{img_id:06d}_{gt_id:06d}.png", mask)
                R = quat.quat_to_matrix(torch.as_tensor(q, dtype=torch.float32)).numpy()
                gt_list.append({"obj_id": obj_id,
                                "cam_R_m2c": R.ravel().tolist(),
                                "cam_t_m2c": (np.asarray(t) * 1000.0).tolist()})
                ys, xs = np.nonzero(mask)
                if xs.size:
                    bbox = [int(xs.min()), int(ys.min()),
                            int(xs.max() - xs.min() + 1), int(ys.max() - ys.min() + 1)]
                else:
                    bbox = [0, 0, 1, 1]
                info_list.append({"visib_fract": visib_fract, "bbox_visib": bbox})

            cams[str(img_id)] = {"cam_K": K, "depth_scale": depth_scale}
            gts[str(img_id)] = gt_list
            infos[str(img_id)] = info_list
            targets.append({"im_id": img_id, "inst_count": n_inst, "obj_id": obj_id,
                            "scene_id": scene_id})
            seconds.append(time.perf_counter() - t_img)
            print(f"  scene {scene_id} img {img_id}: obj {obj_id} x{n_inst}"
                  + (f" + {len(clutter_solos)} clutter" if cad else "")
                  + f", visib {[round(i['visib_fract'], 2) for i in info_list]}"
                  + f", {seconds[-1]:.3f} s")
        (sdir / "scene_camera.json").write_text(json.dumps(cams))
        (sdir / "scene_gt.json").write_text(json.dumps(gts))
        (sdir / "scene_gt_info.json").write_text(json.dumps(infos))
    if "test" in args.split:
        # BOP convention: the targets json belongs to the test split only
        # (train/val splits enumerate scene_gt directly)
        (root / "test_targets_bop19.json").write_text(json.dumps(targets))
    print(f"wrote synthetic BOP dataset: {split_dir} ({args.n_scenes} scenes x "
          f"{args.n_images} images, {len(objects)} objects, profile={args.profile}, "
          f"multi_instance={args.multi_instance}) on {dev}: {sum(seconds):.2f} s, "
          f"{np.mean(seconds):.4f} s per image, {renders} solo renders")
    return {"split_dir": split_dir, "seconds": seconds, "renders": renders}


def main(argv=None):
    return generate(parse_args(argv))


if __name__ == "__main__":
    main()
