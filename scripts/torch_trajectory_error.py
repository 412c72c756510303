"""Offline trajectory evaluation through the PyTorch port (counterpart of
``scripts/trajectory_error.py``): a tracked TUM trajectory against the
ground-truth one. Per frame the translation and rotation error, the ATE
(RMSE of the translation error; no alignment, the object pose is absolute
in the camera frame) and the RPE (the error of the frame-to-frame motion
over ``--rpe-delta`` frames, drift without the absolute offset).

    python scripts/torch_ros_particle_filter.py --export-tum /tmp/track
    python scripts/torch_trajectory_error.py /tmp/track.tum /tmp/track_gt.tum \\
        --out-csv data/exp_pro/tracker_cuda/coordinate_traj.csv

Prints one JSON summary (also written by ``--out-json``); ``--out-csv``
writes stamp, translation error [mm] and rotation error [deg] per frame.
Host code only: NumPy and the port's quaternions on the CPU.
"""

import argparse
import csv
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402
import torch  # noqa: E402


def associate(est_stamps, gt_stamps, max_dt=0.02):
    """Nearest-timestamp association (the TUM tools' convention): index
    pairs (i_est, i_gt) of the estimates within ``max_dt`` of a gt stamp."""
    gt_idx = np.searchsorted(gt_stamps, est_stamps)
    gt_idx = np.clip(gt_idx, 1, len(gt_stamps) - 1)
    left = gt_idx - 1
    pick = np.where(np.abs(gt_stamps[gt_idx] - est_stamps)
                    < np.abs(gt_stamps[left] - est_stamps), gt_idx, left)
    ok = np.abs(gt_stamps[pick] - est_stamps) <= max_dt
    return np.nonzero(ok)[0], pick[ok]


def quat_angle(q1, q2):
    """Angular distance [rad] between quaternion arrays [N, 4] (w, x, y, z),
    sign-invariant."""
    dot = np.abs(np.sum(q1 * q2, axis=1))
    return 2.0 * np.arccos(np.clip(dot, -1.0, 1.0))


def relative_errors(ts, qs, gt_t, gt_q, delta=1):
    """RPE: the error of the motion increment over ``delta`` frames, each
    increment expressed in its earlier frame (float32, as the JAX script's
    default precision computes it)."""
    from bayesianposeestimation.jl_tpu_torch import quaternions as quat

    def rel(t, q):
        q0 = torch.as_tensor(q[:-delta], dtype=torch.float32)
        q1 = torch.as_tensor(q[delta:], dtype=torch.float32)
        dq = quat.qmul(quat.qconj(q0), q1).numpy()
        dt_ = quat.qrotate(quat.qconj(q0),
                           torch.as_tensor(t[delta:] - t[:-delta], dtype=torch.float32)).numpy()
        return dt_, dq

    dt_e, dq_e = rel(ts, qs)
    dt_g, dq_g = rel(gt_t, gt_q)
    trans = np.linalg.norm(dt_e - dt_g, axis=1)
    rot = quat_angle(dq_e / np.linalg.norm(dq_e, axis=1, keepdims=True),
                     dq_g / np.linalg.norm(dq_g, axis=1, keepdims=True))
    return trans, rot


def evaluate(est, gt, max_dt=0.02, rpe_delta=1):
    """(summary, per-frame rows) of a tracked trajectory ``est`` against
    ``gt``, each (stamps, t [N, 3], q [N, 4] w-first) as ``load_tum`` reads it."""
    est_stamps, est_t, est_q = est
    gt_stamps, gt_t, gt_q = gt
    ie, ig = associate(est_stamps, gt_stamps, max_dt)
    if len(ie) == 0:
        raise SystemExit("no timestamp associations within --max-dt")
    t_e, q_e = est_t[ie], est_q[ie]
    t_g, q_g = gt_t[ig], gt_q[ig]
    trans_err = np.linalg.norm(t_e - t_g, axis=1)
    rot_err = quat_angle(q_e, q_g)
    ate_rmse = float(np.sqrt(np.mean(trans_err**2)))
    rpe_t, rpe_r = relative_errors(t_e, q_e, t_g, q_g, rpe_delta)
    summary = {
        "n_frames": int(len(ie)),
        "ate_rmse_mm": round(ate_rmse * 1000, 2),
        "trans_median_mm": round(float(np.median(trans_err)) * 1000, 2),
        "trans_p95_mm": round(float(np.percentile(trans_err, 95)) * 1000, 2),
        "rot_median_deg": round(float(np.degrees(np.median(rot_err))), 2),
        "rot_p95_deg": round(float(np.degrees(np.percentile(rot_err, 95))), 2),
        "rpe_trans_median_mm": round(float(np.median(rpe_t)) * 1000, 2),
        "rpe_rot_median_deg": round(float(np.degrees(np.median(rpe_r))), 2),
    }
    rows = [dict(stamp=float(s), trans_err_mm=float(e), rot_err_deg=float(r))
            for s, e, r in zip(est_stamps[ie], trans_err * 1000, np.degrees(rot_err))]
    return summary, rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("est_tum")
    ap.add_argument("gt_tum")
    ap.add_argument("--max-dt", type=float, default=0.02)
    ap.add_argument("--rpe-delta", type=int, default=1)
    ap.add_argument("--out-csv", default=None)
    ap.add_argument("--out-json", default=None)
    args = ap.parse_args(argv)

    from bayesianposeestimation.jl_tpu_torch.utils.experiment_io import load_tum

    summary, rows = evaluate(load_tum(args.est_tum), load_tum(args.gt_tum), args.max_dt,
                             args.rpe_delta)
    print(json.dumps(summary))
    if args.out_csv:
        Path(args.out_csv).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out_csv, "w", newline="") as fh:
            writer = csv.DictWriter(fh, fieldnames=list(rows[0]))
            writer.writeheader()
            writer.writerows(rows)
        print(f"wrote {args.out_csv}")
    if args.out_json:
        Path(args.out_json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out_json).write_text(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
