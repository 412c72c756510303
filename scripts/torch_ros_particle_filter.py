"""Real-time particle-filter tracking on a depth stream, through the
PyTorch/CUDA port (counterpart of ``scripts/ros_particle_filter.py``).

Bootstrap (1250 particles) and coordinate (600) particle filters at 80x60 px
against a 90 Hz depth sensor. ``--stream x.npz`` reads a recorded depth
stream (``experiment_io.save_depth_stream``'s format; ``convert_rosbag``
makes one from a ROS1 bag) with ``--mesh y.obj`` as the object's model (the
0.08 m monkey without it); frames and intrinsics of another size are
resized to ``--width`` x ``--height``, the priors come from the stream's
first ground-truth pose (or (0, 0, 1) and the identity without one), and
errors and the gate need its ground truth. Without ``--stream`` the stream
is synthetic: an orbiting, bobbing monkey mesh rendered to depth on the card
by the port's ``render_depth`` kernel, over a background plane, with sensor
noise and speckle dropout; ``--events`` adds a transient occluder and three
dropped frames that the tracker's model knows nothing of. The tracker runs
on the 256-face decimation of its mesh.

    python scripts/torch_ros_particle_filter.py --filter coordinate --n-frames 120
    python scripts/torch_ros_particle_filter.py --stream stream.npz --mesh object.obj

Runs on the CUDA device unless ``--device cpu`` is given (slow: the CPU runs
the kernels' plain versions; use a short stream and few particles).
"""

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from bayesianposeestimation.jl_tpu_torch import convert  # noqa: E402
from bayesianposeestimation.jl_tpu_torch import quaternions as quat  # noqa: E402
from bayesianposeestimation.jl_tpu_torch.camera import CvCamera  # noqa: E402
from bayesianposeestimation.jl_tpu_torch.models.fused import mesh_tensors  # noqa: E402
from bayesianposeestimation.jl_tpu_torch.models.particle_filter import (  # noqa: E402
    bootstrap_pf,
    coordinate_pf,
    fused_pf_posterior,
)
from bayesianposeestimation.jl_tpu_torch.ops.cuda_raster import render_depth  # noqa: E402
from bayesianposeestimation.jl_tpu_torch.parameters import Parameters  # noqa: E402
from bayesianposeestimation.jl_tpu_torch.utils import mesh_io  # noqa: E402
from bayesianposeestimation.jl_tpu_torch.utils.bop import depth_resize  # noqa: E402
from bayesianposeestimation.jl_tpu_torch.utils.decimate import decimate  # noqa: E402
from bayesianposeestimation.jl_tpu_torch.utils.experiment_io import (  # noqa: E402
    load_depth_stream,
    save_tum,
)

SENSOR_HZ = 90.0
# particles per filter, and the proposal scales (sigma_t, sigma_r). The
# coordinate filter re-weights each block against the likelihood, so it
# tolerates wide proposals; the bootstrap filter only diffuses, so its
# acceleration noise stays near the true motion scale.
FILTERS = {"coordinate": (600, 0.005, 0.05), "bootstrap": (1250, 0.002, 0.03)}


def _render(mesh, cam, t, q, device):
    """[N] poses -> [N, H, W] depth on the host, rendered by ``render_depth``."""
    verts, faces = mesh_tensors(mesh.vertices, mesh.faces, device)
    t = torch.as_tensor(np.array(t, np.float32), device=device)
    q = torch.as_tensor(np.array(q, np.float32), device=device)
    return render_depth(verts, faces, cam, t.contiguous(), q.contiguous(),
                        device=device).cpu().numpy()


def synthetic_stream(n_frames, width, height, seed=0, with_events=False, device="cuda"):
    """Orbit + bob trajectory of the 0.18 m monkey at ~0.5 m (about 32 px of
    the 80x60 frame) over a background plane at 1.1 m, 5 mm depth noise and
    2 % speckle dropout (0 = no return). ``with_events``: a 10 cm cube sweeps
    in front of the object for a fifth of the stream, and three consecutive
    frames are dropped (every pixel invalid). Returns (stream dict of host
    arrays and the camera, mesh)."""
    mesh = mesh_io.monkey_mesh(0.18)
    cam = CvCamera(width=width, height=height, f_x=1.1 * width, f_y=1.1 * width,
                   c_x=(width - 1) / 2, c_y=(height - 1) / 2, near=0.01, far=10.0)
    ts_ = np.linspace(0, 2 * np.pi, n_frames)
    gt_t = np.stack([0.04 * np.sin(ts_), 0.03 * np.cos(ts_), 0.50 + 0.03 * np.sin(2 * ts_)], 1)
    gt_q = quat.qexp(torch.as_tensor(
        np.stack([0.8 * ts_, 0.2 * np.sin(ts_), 0.1 * ts_], 1), dtype=torch.float32)).numpy()
    depth = _render(mesh, cam, gt_t, gt_q, device)
    depth = np.where(depth > 0, depth, 1.1)
    rng = np.random.default_rng(seed)
    events = {"occluded": np.zeros(n_frames, bool), "dropped": np.zeros(n_frames, bool)}
    if with_events:
        occ = mesh_io.cube_mesh(0.10)
        f0, f1 = int(0.35 * n_frames), int(0.55 * n_frames)
        sweep = np.linspace(-0.18, 0.18, f1 - f0)
        occ_t = np.stack([sweep, np.zeros_like(sweep), np.full_like(sweep, 0.38)], 1)
        occ_q = np.broadcast_to(np.asarray([1.0, 0, 0, 0], np.float32), (f1 - f0, 4))
        occ_d = _render(occ, cam, occ_t, occ_q, device)
        depth[f0:f1] = np.minimum(depth[f0:f1], np.where(occ_d > 0, occ_d, np.inf))
        events["occluded"][f0:f1] = True
    noisy = depth + rng.normal(0, 0.005, depth.shape)
    noisy = np.where(rng.random(depth.shape) < 0.02, 0.0, noisy)
    if with_events:
        d0 = int(0.7 * n_frames)
        noisy[d0:d0 + 3] = 0.0
        events["dropped"][d0:d0 + 3] = True
    return dict(depth=noisy.astype(np.float32), camera=cam, gt_t=gt_t.astype(np.float32),
                gt_q=gt_q.astype(np.float32), **events), mesh


def filter_params(kind, width, height, n_particles=None, device="cuda") -> Parameters:
    n_default, sigma_t, sigma_r = FILTERS[kind]
    return Parameters(width=width, height=height, n_particles=n_particles or n_default,
                      proposal_sigma_t=(sigma_t,) * 3, proposal_sigma_r=(sigma_r,) * 3,
                      device=str(device))


def recorded_stream(path, mesh_path="monkey"):
    """(stream, mesh) of a recorded depth stream: the ``.npz`` at ``path``
    and the OBJ model at ``mesh_path``, or the 0.08 m monkey if that names
    no ``.obj``."""
    mesh = (mesh_io.load_obj(mesh_path) if str(mesh_path).endswith(".obj")
            else mesh_io.monkey_mesh(0.08))
    return load_depth_stream(path), mesh


def tracking_setup(stream, mesh, params, device="cuda", n_faces=256):
    """The tracker's inputs: the experiment (decimated mesh, camera scaled to
    the render size, priors from the first ground-truth pose, or (0, 0, 1)
    and the identity for a stream without one) on the CPU and the stream on
    ``device`` with invalid pixels +inf."""
    mesh = decimate(mesh, n_faces)
    cam = stream["camera"]
    if (cam.width, cam.height) != (params.width, params.height):
        cam = cam.scale_to(params.width, params.height)
    depth = stream["depth"]
    if depth.shape[1:] != (params.height, params.width):
        depth = np.stack([depth_resize(d, params.width, params.height) for d in depth])
    prior_t = stream["gt_t"][0] if "gt_t" in stream else np.asarray([0.0, 0.0, 1.0], np.float32)
    prior_r = (stream["gt_q"][0] if "gt_q" in stream
               else np.asarray([1.0, 0.0, 0.0, 0.0], np.float32))
    experiment = convert.experiment_from_numpy(
        cam, mesh.vertices, mesh.faces, params.o_mask_is, prior_t, depth[0], prior_r=prior_r)
    return experiment, convert.stream_from_numpy(depth, device), mesh


def pose_estimates(outs):
    """Per frame: the weighted-mean translation and the chordal-mean rotation
    (principal eigenvector of Σ w q qᵀ, sign-invariant), as host arrays."""
    w = np.exp(outs["log_weights"].cpu().numpy().astype(np.float64))
    est_t = np.einsum("fn,fnd->fd", w, outs["t"].cpu().numpy())
    qs = outs["r"].cpu().numpy()
    _, eigvecs = np.linalg.eigh(np.einsum("fn,fni,fnj->fij", w, qs, qs))
    est_q = eigvecs[:, :, -1]
    est_q *= np.where(est_q[:, :1] < 0, -1.0, 1.0)
    return est_t, est_q


def tracking_errors(est_t, est_q, stream, with_events=False):
    """Errors against the stream's ground truth and the pass gate: without
    events median translation error < 5 mm and median rotation error < 10
    degrees; with events a clean-frame median < 5 mm and re-acquisition
    (< 5 mm) within 15 frames of the last event frame."""
    err = np.linalg.norm(est_t - stream["gt_t"][1:], axis=1)
    dot = np.abs(np.sum(est_q * stream["gt_q"][1:], axis=1))
    rot_err = 2.0 * np.degrees(np.arccos(np.clip(dot, -1.0, 1.0)))
    res = {"median_error_mm": float(np.median(err) * 1e3),
           "mean_error_mm": float(err.mean() * 1e3),
           "median_rot_deg": float(np.median(rot_err)), "recovery": None,
           "finite": bool(np.isfinite(err).all() and np.isfinite(rot_err).all())}
    if with_events:
        event = np.asarray(stream["occluded"][1:] | stream["dropped"][1:], bool)
        event_end = max(np.flatnonzero(event), default=-1)
        post = err[event_end + 1:]
        reacq = next((i for i, e in enumerate(post) if e < 0.005), None)
        res["recovery"] = {
            "median_err_mm_clean": float(np.median(err[~event]) * 1e3),
            "max_err_mm_during_events": float(err[event].max() * 1e3) if event.any() else None,
            "frames_to_reacquire": reacq,
            "median_err_mm_post_event": float(np.median(post) * 1e3) if post.size else None,
        }
        res["ok"] = bool(res["finite"] and res["recovery"]["median_err_mm_clean"] < 5.0
                         and reacq is not None and reacq <= 15)
    else:
        res["ok"] = bool(res["finite"] and res["median_error_mm"] < 5.0
                         and res["median_rot_deg"] < 10.0)
    return res


def timed_runs(pf, posterior_fn, params, experiment, depth, device, seed=0, repeats=3):
    """One warm-up run, then ``repeats`` runs timed on the host clock, each
    ending in a device synchronisation. Returns (outs, final, first-run
    seconds, list of run seconds)."""
    def sync():
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()

    def run():
        sync()
        t0 = time.perf_counter()
        outs, final = pf(seed, posterior_fn, params, experiment, depth, device=device)
        sync()
        return outs, final, time.perf_counter() - t0

    _, _, first = run()
    runs = [run() for _ in range(repeats)]
    return runs[-1][0], runs[-1][1], first, [r[2] for r in runs]


def card_line(device):
    """The device's name and power limit as nvidia-smi prints them (the
    device type on the CPU)."""
    if torch.device(device).type != "cuda":
        return "cpu"
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[0]


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--filter", default="coordinate", choices=sorted(FILTERS))
    ap.add_argument("--n-particles", type=int, default=None,
                    help="default: 600 coordinate / 1250 bootstrap")
    ap.add_argument("--width", type=int, default=80)
    ap.add_argument("--height", type=int, default=60)
    ap.add_argument("--n-frames", type=int, default=120)
    ap.add_argument("--stream", default=None,
                    help="a recorded .npz depth stream (see experiment_io.convert_rosbag)")
    ap.add_argument("--mesh", default="monkey",
                    help="the object's .obj model for --stream (default the 0.08 m monkey)")
    ap.add_argument("--events", action="store_true",
                    help="inject a transient occluder and dropped frames into the synthetic "
                         "stream and report recovery statistics")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out-json", default=None, help="write the fps/error record here")
    ap.add_argument("--export-tum", default=None,
                    help="write the tracked and true trajectories as <path>.tum / <path>_gt.tum")
    args = ap.parse_args()
    if args.stream and args.events:
        ap.error("--events applies to the synthetic stream, not to --stream")

    params = filter_params(args.filter, args.width, args.height, args.n_particles, args.device)
    if args.stream:
        stream, mesh = recorded_stream(args.stream, args.mesh)
    else:
        stream, mesh = synthetic_stream(args.n_frames, args.width, args.height, seed=args.seed,
                                        with_events=args.events, device=args.device)
    experiment, depth, _ = tracking_setup(stream, mesh, params, args.device)
    pf = coordinate_pf if args.filter == "coordinate" else bootstrap_pf
    outs, _, first, runs = timed_runs(pf, fused_pf_posterior("simple"), params, experiment,
                                      depth, args.device, seed=args.seed)
    n_tracked = depth.shape[0] - 1
    fps = n_tracked / statistics.median(runs)
    card = card_line(args.device)
    print(f"{args.filter} PF: {params.n_particles} particles at {args.width}x{args.height}, "
          f"{n_tracked} frames on {card}")
    print(f"first run {first:.4f} s; timed runs {[round(r, 4) for r in runs]} s -> {fps} fps "
          f"(median run; sensor: {SENSOR_HZ} Hz)")

    est_t, est_q = pose_estimates(outs)
    has_gt = "gt_t" in stream
    if args.export_tum:
        base = Path(args.export_tum)
        base.parent.mkdir(parents=True, exist_ok=True)
        stamps = stream.get("stamps")
        if stamps is None:
            stamps = np.arange(depth.shape[0]) / SENSOR_HZ
        save_tum(str(base) + ".tum", stamps[1:], est_t, est_q)
        if has_gt:
            save_tum(str(base) + "_gt.tum", stamps, stream["gt_t"], stream["gt_q"])
        print(f"wrote {base}.tum" + (f" and {base}_gt.tum" if has_gt else ""))
    res = {"ok": True, "median_error_mm": None, "median_rot_deg": None, "recovery": None}
    if has_gt:
        res = tracking_errors(est_t, est_q, stream, args.events)
        print(f"mean translation error {res['mean_error_mm']:.2f} mm (median "
              f"{res['median_error_mm']:.2f} mm); median rotation error "
              f"{res['median_rot_deg']:.2f} deg")
    if res["recovery"]:
        print(f"events: {json.dumps(res['recovery'])}")
    record = {
        "metric": f"{args.filter}-pf fps ({params.n_particles} particles, "
                  f"{args.width}x{args.height})" + (" +events" if args.events else ""),
        "value": fps, "unit": "fps", "vs_sensor_rate": fps / SENSOR_HZ, "device": card,
        "first_run_s": first, "runs_s": runs,
        "median_error_mm": res["median_error_mm"], "median_rot_deg": res["median_rot_deg"],
        "recovery": res["recovery"],
    }
    print(json.dumps(record))
    if args.out_json:
        Path(args.out_json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out_json).write_text(json.dumps(record))
    print("RESULT:", "PASS" if res["ok"] else "FAIL")
    return 0 if res["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
