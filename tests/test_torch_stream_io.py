"""Port parity: depth-stream ingestion and checkpoints against the JAX package.

Every case of ``tests/test_rosbag.py`` and the bag cases of
``tests/test_spec_fixtures.py`` (the spec-authored fixture
``tests/fixtures/rosbag/tracker.bag``) run through both packages' ``rosbag``
modules as one parametrised test; both writers give the same bytes for the
same messages. Both packages' ``convert_rosbag`` make equal ``.npz``
contents from one bag, a depth stream, a TUM trajectory and an OBJ model
written by either package load in the other, the port's bootstrap filter
tracks the bag-derived 32x24 stream through ``scripts/torch_ros_particle_
filter.py``'s ``--stream`` set-up under ``test_bag_stream_drives_tracker``'s
gate, and an ``SmcState`` / ``MCMCState`` checkpoint of either package
restores in the other with equal values.
"""

import struct
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesianposeestimation.jl_tpu.camera import CvCamera as JCam
from bayesianposeestimation.jl_tpu.samplers.mh import MCMCState as JMCMCState
from bayesianposeestimation.jl_tpu.samplers.smc import SmcState as JSmcState
from bayesianposeestimation.jl_tpu.samples import Sample as JSample
from bayesianposeestimation.jl_tpu.utils import checkpoint as jckpt
from bayesianposeestimation.jl_tpu.utils import experiment_io as jio
from bayesianposeestimation.jl_tpu.utils import mesh_io as jmesh
from bayesianposeestimation.jl_tpu.utils import rosbag as jbag
from bayesianposeestimation.jl_tpu_torch.camera import CvCamera
from bayesianposeestimation.jl_tpu_torch.models.particle_filter import (
    bootstrap_pf,
    fused_pf_posterior,
)
from bayesianposeestimation.jl_tpu_torch.ops.rasterize import render_depth_batch
from bayesianposeestimation.jl_tpu_torch.parameters import Parameters
from bayesianposeestimation.jl_tpu_torch.samplers.mh import MCMCState
from bayesianposeestimation.jl_tpu_torch.samplers.smc import SmcState
from bayesianposeestimation.jl_tpu_torch.samples import Sample
from bayesianposeestimation.jl_tpu_torch.utils import checkpoint as tckpt
from bayesianposeestimation.jl_tpu_torch.utils import experiment_io as tio
from bayesianposeestimation.jl_tpu_torch.utils import mesh_io as tmesh
from bayesianposeestimation.jl_tpu_torch.utils import rosbag as tbag

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "scripts"))
import torch_ros_particle_filter as track  # noqa: E402

BAGS = {"jax": jbag, "port": tbag}
IOS = {"jax": jio, "port": tio}
FIXTURE = REPO / "tests" / "fixtures" / "rosbag" / "tracker.bag"
W, H, F = 32, 24, 5
CAM = dict(width=W, height=H, f_x=40.0, f_y=40.0, c_x=(W - 1) / 2, c_y=(H - 1) / 2,
           near=0.01, far=10.0)


def _cube_frames():
    """F depth frames of the 0.1 m cube drifting in x at 1 m, and its path."""
    mesh = tmesh.cube_mesh(0.1)
    ts = np.stack([[0.01 * i, 0.0, 1.0] for i in range(F)]).astype(np.float32)
    qs = np.tile(np.asarray([1.0, 0, 0, 0], np.float32), (F, 1))
    depth = render_depth_batch(torch.as_tensor(mesh.vertices), torch.as_tensor(mesh.faces),
                               CvCamera(**CAM), torch.as_tensor(ts), torch.as_tensor(qs))
    return depth.numpy(), ts


def _messages(depth, ts, encoding="16UC1"):
    """test_rosbag.py's bag: camera info, then per frame an image and a pose."""
    K = np.asarray([[CAM["f_x"], 0, CAM["c_x"]], [0, CAM["f_y"], CAM["c_y"]], [0, 0, 1]])
    msgs = [("/camera/info", "sensor_msgs/CameraInfo", 0, dict(height=H, width=W, K=K.ravel()))]
    for i in range(F):
        raw = ((depth[i] * 1000.0).astype("<u2") if encoding == "16UC1"
               else depth[i].astype("<f4")).tobytes()
        stamp_ns = int(1e9 + i * 1e7)
        msgs.append(("/camera/depth", "sensor_msgs/Image", stamp_ns,
                     dict(height=H, width=W, encoding=encoding, data=raw,
                          header=dict(stamp=stamp_ns * 1e-9))))
        msgs.append(("/gt_pose", "geometry_msgs/PoseStamped", stamp_ns,
                     dict(position=dict(x=float(ts[i, 0]), y=float(ts[i, 1]), z=float(ts[i, 2])),
                          orientation=dict(x=0.0, y=0.0, z=0.0, w=1.0))))
    return msgs


def _record(header_fields, data):
    """A spec-conformant bag record, built independently of either writer."""
    h = b""
    for name, value in header_fields.items():
        item = name.encode() + b"=" + value
        h += struct.pack("<I", len(item)) + item
    return struct.pack("<I", len(h)) + h + struct.pack("<I", len(data)) + data


# -- the cases of tests/test_rosbag.py and tests/test_spec_fixtures.py -------

def case_roundtrip(bag, tmp_path):
    depth, ts = _cube_frames()
    path = tmp_path / "t.bag"
    bag.write_bag(path, _messages(depth, ts))
    seen = list(bag.read_bag(path))
    topics = [t for t, *_ in seen]
    assert (topics.count("/camera/depth"), topics.count("/camera/info"),
            topics.count("/gt_pose")) == (F, 1, F)
    img = [m for _, ty, _, m in seen if ty == "sensor_msgs/Image"][0]
    assert img["encoding"] == "16UC1"
    got = np.frombuffer(img["data"], "<u2").reshape(H, W) / 1000.0
    np.testing.assert_allclose(got, depth[0], atol=1e-3)


def case_spec_time_field(bag, tmp_path):
    pose = (struct.pack("<III", 0, 7, 123) + struct.pack("<I", 0)
            + struct.pack("<7d", 1.0, 2.0, 3.0, 0.0, 0.0, 0.0, 1.0))
    inner = b""
    for name, value in {"topic": b"/p", "type": b"geometry_msgs/PoseStamped"}.items():
        item = name.encode() + b"=" + value
        inner += struct.pack("<I", len(item)) + item
    conn = _record({"op": b"\x07", "conn": struct.pack("<I", 0), "topic": b"/p"}, inner)
    msg = _record({"op": b"\x02", "conn": struct.pack("<I", 0),
                   "time": struct.pack("<II", 7, 123)}, pose)
    raw = (b"#ROSBAG V2.0\n"
           + _record({"op": b"\x03", "index_pos": struct.pack("<Q", 0),
                      "conn_count": struct.pack("<I", 1),
                      "chunk_count": struct.pack("<I", 1)}, b" " * 4096)
           + _record({"op": b"\x05", "compression": b"none",
                      "size": struct.pack("<I", len(conn + msg))}, conn + msg))
    path = tmp_path / "spec.bag"
    path.write_bytes(raw)
    [(topic, msgtype, stamp_ns, m)] = list(bag.read_bag(path))
    assert (topic, msgtype, stamp_ns) == ("/p", "geometry_msgs/PoseStamped", 7 * 10**9 + 123)
    assert m["position"] == dict(x=1.0, y=2.0, z=3.0)


def case_writer_time_field(bag, tmp_path):
    path = tmp_path / "w.bag"
    bag.write_bag(path, [("/gt", "geometry_msgs/PoseStamped", 5 * 10**9 + 42,
                          dict(position=dict(x=0.0, y=0.0, z=0.0),
                               orientation=dict(x=0.0, y=0.0, z=0.0, w=1.0)))])
    assert b"time=" + struct.pack("<II", 5, 42) in path.read_bytes()


def case_unknown_compression(bag, tmp_path):
    path = tmp_path / "lz4.bag"
    path.write_bytes(b"#ROSBAG V2.0\n" + _record(
        {"op": b"\x05", "compression": b"lz4", "size": struct.pack("<I", 0)}, b"garbage"))
    with pytest.raises(ValueError, match="lz4"):
        list(bag.read_bag(path))


def case_fixture_bz2_chunk(bag, tmp_path):
    assert [m[1] for m in bag.read_bag(FIXTURE)] == [
        "sensor_msgs/Image", "sensor_msgs/CameraInfo", "geometry_msgs/PoseStamped"]


def case_fixture_image(bag, tmp_path):
    topic, _, stamp, msg = next(iter(bag.read_bag(FIXTURE, topics={"/camera/depth/image_rect"})))
    assert topic == "/camera/depth/image_rect"
    assert stamp == 1700000000 * 10**9 + 250000000
    assert (msg["height"], msg["width"], msg["encoding"]) == (2, 2, "16UC1")
    np.testing.assert_array_equal(np.frombuffer(msg["data"], "<u2").reshape(2, 2),
                                  [[500, 600], [700, 800]])
    assert msg["header"]["frame_id"] == "camera_depth_frame"
    assert abs(msg["header"]["stamp"] - 1700000000.25) < 1e-6


def case_fixture_topic_in_connection_data(bag, tmp_path):
    [(_, msgtype, stamp, msg)] = list(bag.read_bag(FIXTURE, topics={"/tf_gt_pose"}))
    assert msgtype == "geometry_msgs/PoseStamped"
    assert stamp == 1700000000 * 10**9 + 300000000
    assert msg["position"] == {"x": 0.1, "y": -0.2, "z": 0.9}
    assert msg["orientation"]["w"] == 1.0


def case_fixture_camera_info(bag, tmp_path):
    [(_, _, _, msg)] = list(bag.read_bag(FIXTURE, topics={"/camera/depth/camera_info"}))
    np.testing.assert_allclose(np.asarray(msg["K"]).reshape(3, 3)[0], [525.0, 0.0, 319.5])
    np.testing.assert_allclose(msg["D"][:2], [0.1, -0.2])
    assert (msg["height"], msg["width"]) == (480, 640)


BAG_CASES = [case_roundtrip, case_spec_time_field, case_writer_time_field,
             case_unknown_compression, case_fixture_bz2_chunk, case_fixture_image,
             case_fixture_topic_in_connection_data, case_fixture_camera_info]


@pytest.mark.parametrize("package", sorted(BAGS))
@pytest.mark.parametrize("case", BAG_CASES, ids=lambda c: c.__name__[5:])
def test_rosbag_case(case, package, tmp_path):
    case(BAGS[package], tmp_path)


@pytest.mark.parametrize("encoding", ["16UC1", "32FC1"])
def test_writers_give_the_same_bytes(encoding, tmp_path):
    depth, ts = _cube_frames()
    msgs = _messages(depth, ts, encoding)
    jbag.write_bag(tmp_path / "j.bag", msgs)
    tbag.write_bag(tmp_path / "t.bag", msgs)
    assert (tmp_path / "j.bag").read_bytes() == (tmp_path / "t.bag").read_bytes()


@pytest.mark.parametrize("encoding", ["16UC1", "32FC1"])
@pytest.mark.parametrize("package", sorted(IOS))
def test_convert_rosbag(package, encoding, tmp_path):
    """test_rosbag.py's conversion through each package; both packages'
    streams from the bag are equal key by key."""
    depth, ts = _cube_frames()
    bag = tmp_path / "t.bag"
    tbag.write_bag(bag, _messages(depth, ts, encoding))
    paths = {p: IOS[p].convert_rosbag(bag, tmp_path / f"{p}.npz", "/camera/depth",
                                      "/camera/info", "/gt_pose") for p in IOS}
    stream = IOS[package].load_depth_stream(paths[package])
    assert stream["depth"].shape == (F, H, W)
    np.testing.assert_allclose(stream["depth"], depth, atol=1e-3 if encoding == "16UC1" else 1e-6)
    assert stream["camera"].width == W and stream["camera"].f_x == CAM["f_x"]
    np.testing.assert_allclose(stream["gt_t"], ts, atol=1e-7)
    np.testing.assert_allclose(stream["gt_q"][:, 0], 1.0)
    with np.load(paths["jax"]) as a, np.load(paths["port"]) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_stream_across_packages(writer, reader, tmp_path):
    rng = np.random.default_rng(3)
    depth = rng.uniform(0.4, 1.2, (4, 6, 8)).astype(np.float32)
    cam_fields = dict(width=8, height=6, f_x=7.5, f_y=7.25, c_x=3.5, c_y=2.75, s=0.1)
    cam = (JCam if writer == "jax" else CvCamera)(**cam_fields)
    stamps = np.arange(4) * 0.011
    gt_t = rng.normal(size=(4, 3))
    gt_q = rng.normal(size=(4, 4))
    gt_q /= np.linalg.norm(gt_q, axis=1, keepdims=True)
    path = tmp_path / "s.npz"
    IOS[writer].save_depth_stream(path, depth, cam, stamps, gt_t, gt_q)
    got = IOS[reader].load_depth_stream(path)
    np.testing.assert_array_equal(got["depth"], depth)
    for k, v in cam_fields.items():
        assert getattr(got["camera"], k) == pytest.approx(v, rel=1e-6), k
    np.testing.assert_array_equal(got["stamps"], stamps)
    np.testing.assert_array_equal(got["gt_t"], gt_t.astype(np.float32))
    np.testing.assert_array_equal(got["gt_q"], gt_q.astype(np.float32))


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "port")])
def test_tum_round_trip(writer, reader, tmp_path):
    rng = np.random.default_rng(4)
    stamps = 1700000000.0 + np.arange(5) / 90.0
    ts = rng.normal(size=(5, 3))
    qs = rng.normal(size=(5, 4))
    qs /= np.linalg.norm(qs, axis=1, keepdims=True)
    IOS[writer].save_tum(tmp_path / "x.tum", stamps, ts, qs)
    got_stamps, got_t, got_q = IOS[reader].load_tum(tmp_path / "x.tum")
    ref = jio.load_tum(tmp_path / "x.tum")
    np.testing.assert_allclose(got_stamps, stamps, rtol=1e-9)
    np.testing.assert_allclose(got_t, ts, rtol=1e-8, atol=1e-9)
    np.testing.assert_allclose(got_q, qs, rtol=1e-8, atol=1e-9)
    for a, b in zip((got_stamps, got_t, got_q), ref):
        np.testing.assert_array_equal(a, b)


def test_ros_messages_match():
    info = dict(K=np.arange(9.0) + 1.0, width=64, height=48)
    cj, ct = jio.camera_from_info(info), tio.camera_from_info(info)
    for k in ("width", "height", "f_x", "f_y", "c_x", "c_y", "s"):
        assert getattr(cj, k) == getattr(ct, k), k
    img = np.arange(12, dtype="<u2").reshape(3, 4) * 7
    for enc, raw in (("16UC1", img.tobytes()), ("32FC1", (img / 3.0).astype("<f4").tobytes())):
        msg = dict(encoding=enc, data=raw, width=4, height=3)
        np.testing.assert_array_equal(jio.ros_depth_img(msg), tio.ros_depth_img(msg))
    with pytest.raises(ValueError, match="encoding"):
        tio.ros_depth_img(dict(encoding="8UC3", data=b"", width=0, height=0))
    pose = dict(position=dict(x=0.1, y=-0.2, z=0.9), orientation=dict(x=0.1, y=0.2, z=0.3, w=0.9))
    for a, b in zip(jio.ros_pose(pose), tio.ros_pose(pose)):
        np.testing.assert_array_equal(a, b)


def _write_obj(path, mesh, reverse=False, quad=False):
    """An OBJ of the mesh's triangles (texture and normal indices in some
    records), optionally with inward winding and one extra quad."""
    faces = mesh.faces[:, ::-1] if reverse else mesh.faces
    lines = [f"v {x:.9g} {y:.9g} {z:.9g}" for x, y, z in mesh.vertices]
    lines += [f"f {a + 1}/1 {b + 1}//2 {c + 1}" for a, b, c in faces]
    if quad:
        lines.append("f 1 2 3 4")
    path.write_text("# test\n" + "\n".join(lines) + "\n")


@pytest.mark.parametrize("reverse", [False, True])
def test_load_obj_matches(reverse, tmp_path):
    mesh = tmesh.icosphere_mesh(0.05, 1)
    _write_obj(tmp_path / "m.obj", mesh, reverse, quad=True)
    a, b = jmesh.load_obj(str(tmp_path / "m.obj"), 2.0), tmesh.load_obj(tmp_path / "m.obj", 2.0)
    np.testing.assert_array_equal(a.vertices, b.vertices)
    np.testing.assert_array_equal(a.faces, b.faces)
    assert b.n_faces == mesh.n_faces + 2


def test_bag_stream_drives_tracker(tmp_path):
    """Bag -> convert_rosbag -> the tracking script's --stream set-up (OBJ
    model, decimation, priors from the first gt pose) -> the port's
    bootstrap filter on the CPU: test_rosbag.py's gate, max error < 0.06 m."""
    depth, ts = _cube_frames()
    tbag.write_bag(tmp_path / "t.bag", _messages(depth, ts))
    tio.convert_rosbag(tmp_path / "t.bag", tmp_path / "stream.npz", "/camera/depth",
                       "/camera/info", "/gt_pose")
    _write_obj(tmp_path / "cube.obj", tmesh.cube_mesh(0.1))
    stream, mesh = track.recorded_stream(tmp_path / "stream.npz", str(tmp_path / "cube.obj"))
    params = Parameters(width=W, height=H, n_particles=32, proposal_sigma_t=(0.01,) * 3,
                        proposal_sigma_r=(0.05,) * 3, device="cpu")
    experiment, stream_t, small = track.tracking_setup(stream, mesh, params, "cpu")
    assert small.n_faces == 12
    outs, _ = bootstrap_pf(0, fused_pf_posterior("simple"), params, experiment, stream_t,
                           device="cpu")
    est_t, _ = track.pose_estimates(outs)
    err = np.linalg.norm(est_t - stream["gt_t"][1:], axis=1)
    assert np.isfinite(err).all()
    assert err.max() < 0.06, err


def _states(rng, n=6):
    """The same SmcState and MCMCState in both packages."""
    t, r = rng.normal(size=(n, 3)).astype(np.float32), rng.normal(size=(n, 4)).astype(np.float32)
    lp, ll = rng.normal(size=n).astype(np.float32), rng.normal(size=n).astype(np.float32)
    lw = rng.normal(size=n).astype(np.float32)
    js = JSample({"t": jnp.asarray(t), "r": jnp.asarray(r)}, jnp.asarray(lp), jnp.asarray(ll))
    ts_ = Sample({"t": torch.as_tensor(t), "r": torch.as_tensor(r)}, torch.as_tensor(lp),
                 torch.as_tensor(ll))
    scalars = [np.float32(x) for x in rng.normal(size=3)]
    return {
        "smc": (JSmcState(js, jnp.asarray(lw), *map(jnp.asarray, scalars)),
                SmcState(ts_, torch.as_tensor(lw), *map(torch.as_tensor, scalars))),
        "mcmc": (JMCMCState(js, jnp.asarray(scalars[0])),
                 MCMCState(ts_, torch.as_tensor(scalars[0]))),
    }


def _leaves(state):
    s = state.sample
    out = [s.variables["r"], s.variables["t"], s.log_prob, s.log_like]
    if isinstance(state, (SmcState, JSmcState)):
        out += [state.log_weights, state.log_evidence, state.temperature, state.log_relative_ess]
    else:
        out.append(state.temperature)
    return [np.asarray(x) for x in out]


@pytest.mark.parametrize("kind", ["smc", "mcmc"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoint_across_packages(writer, kind, tmp_path):
    jstate, tstate = _states(np.random.default_rng(5))[kind]
    path = tmp_path / "state.npz"
    if writer == "jax":
        jckpt.save_state(path, jstate)
        like = _states(np.random.default_rng(6))[kind][1]
        got = tckpt.load_state(path, like)
        assert type(got) is type(tstate)
        assert got.sample.variables["t"].dtype == torch.float32
        assert list(got.sample.variables) == list(like.sample.variables)
    else:
        tckpt.save_state(path, tstate)
        got = jckpt.load_state(path, _states(np.random.default_rng(6))[kind][0])
        assert type(got) is type(jstate)
    for a, b in zip(_leaves(got), _leaves(jstate)):
        np.testing.assert_array_equal(a, b)


def test_checkpoint_none_leaves_and_count(tmp_path):
    """None densities are skipped as JAX skips them; a checkpoint of another
    structure is refused."""
    state = MCMCState(Sample({"t": torch.ones(2, 3)}), torch.tensor(0.5))
    tckpt.save_state(tmp_path / "a.npz", state)
    with np.load(tmp_path / "a.npz") as f:
        assert sorted(f.files) == ["leaf_0", "leaf_1"]
    got = tckpt.load_state(tmp_path / "a.npz", state)
    assert got.sample.log_prob is None and float(got.temperature) == 0.5
    bigger = MCMCState(Sample({"t": torch.ones(2, 3)}, torch.zeros(2), torch.zeros(2)),
                       torch.tensor(0.5))
    with pytest.raises(ValueError, match="leaves"):
        tckpt.load_state(tmp_path / "a.npz", bigger)


def test_port_rejects_a_file_that_is_no_bag(tmp_path):
    (tmp_path / "x.bag").write_bytes(b"#ROSBAG V1.2\n")
    with pytest.raises(ValueError, match="not a ROS1 v2.0 bag"):
        list(tbag.read_bag(tmp_path / "x.bag"))


@pytest.mark.parametrize("with_gt", [True, False])
def test_tracking_script_on_a_recorded_stream(with_gt, tmp_path, monkeypatch, capsys):
    """scripts/torch_ros_particle_filter.py --stream --mesh on the CPU: the
    record's errors need the stream's ground truth, and the TUM export takes
    the stream's stamps; without ground truth it tracks from (0, 0, 1) and
    reports no error."""
    import json

    depth, ts = _cube_frames()
    cam = CvCamera(**CAM)
    stamps = 12.5 + np.arange(F) / 90.0  # TUM keeps 9 significant digits
    tio.save_depth_stream(tmp_path / "s.npz", depth, cam, stamps,
                          ts if with_gt else None, np.tile([1.0, 0, 0, 0], (F, 1)))
    _write_obj(tmp_path / "cube.obj", tmesh.cube_mesh(0.1))
    monkeypatch.setattr(sys, "argv", [
        "x", "--stream", str(tmp_path / "s.npz"), "--mesh", str(tmp_path / "cube.obj"),
        "--filter", "bootstrap", "--n-particles", "16", "--width", str(W), "--height", str(H),
        "--device", "cpu", "--export-tum", str(tmp_path / "track")])
    rc = track.main()
    out = capsys.readouterr().out
    record = json.loads(next(ln for ln in out.splitlines() if ln.startswith("{")))
    got_stamps, _, _ = tio.load_tum(tmp_path / "track.tum")
    np.testing.assert_allclose(got_stamps, stamps[1:], rtol=1e-8)
    assert (tmp_path / "track_gt.tum").exists() == with_gt
    if with_gt:
        assert np.isfinite(record["median_error_mm"]) and rc in (0, 1)
    else:
        assert record["median_error_mm"] is None and rc == 0 and "RESULT: PASS" in out
