"""Particle sharding in the port (``jl_tpu_torch/parallel/sharded.py``) and
the process-level sweep (``jl_tpu_torch/parallel/sweep.py``).

The sharded chain runs in 1, 2 and 4 processes (``torch.multiprocessing``
spawn, gloo, a ``file://`` store under the test's temporary directory) on
``tests/test_multichip.py``'s model in the port: the fused association
posterior of a 12-face cube at 16x16, ``smc_mh``, 32 particles, 5 steps.
With the same seed every world size makes the same draws, so the chains
agree up to the order of the reductions: the evidence trace within
``tests/test_multichip.py``'s 2e-3, the sorted final log-likelihoods within
2e-3, the best particle's t within 1e-4, the resampling indices identical.
Against ``sample_chain`` in one process the one-process sharded chain is
equal to the bit (each process sums its particles as the unsharded step
does; an all-reduce over one process adds nothing). Sharded systematic resampling passes the
offspring chi-square test of ``tests/test_multichip.py:171-202``; a
particle count the world size does not divide raises.
"""

import os

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from bayesianposeestimation.jl_tpu_torch.parallel.sweep import run_sweep, shard_configs
from bayesianposeestimation.jl_tpu_torch.utils.artifacts import collect_results, savename

N_PARTICLES, N_STEPS, SEED = 32, 5, 11
TOL = dict(rtol=2e-3, atol=2e-3)  # tests/test_multichip.py's evidence and log-likelihood gate
BEST_T_ATOL = 1e-4
CHI2_REPS = 256


def cube_model():
    """The cube scene of tests/test_multichip.py:19-49 in the port: 0.1 m
    cube at (0.01, -0.02, 1.0) m, a 16x16 crop of a 640x480 camera, depth
    noise 1 cm; the fused association posterior on the CPU and ``smc_mh``."""
    from bayesianposeestimation.jl_tpu_torch import quaternions as quat
    from bayesianposeestimation.jl_tpu_torch.camera import CvCamera, crop_camera
    from bayesianposeestimation.jl_tpu_torch.models.experiment_samplers import smc_mh
    from bayesianposeestimation.jl_tpu_torch.models.fused import fused_posterior
    from bayesianposeestimation.jl_tpu_torch.ops.rasterize import render_depth
    from bayesianposeestimation.jl_tpu_torch.parameters import Experiment, Parameters
    from bayesianposeestimation.jl_tpu_torch.utils import mesh_io

    params = Parameters(width=16, height=16, n_particles=N_PARTICLES, n_steps=N_STEPS,
                        proposal_sigma_r=(0.5, 0.5, 0.5), device="cpu")
    mesh = mesh_io.cube_mesh(0.1)
    base = CvCamera(width=640, height=480, f_x=600.0, f_y=600.0, c_x=319.5, c_y=239.5,
                    near=0.01, far=10.0)
    gt_t = np.array([0.01, -0.02, 1.0], np.float32)
    cam = crop_camera(base, gt_t, mesh_io.mesh_diameter(mesh), width=16, height=16)
    rng = np.random.default_rng(7)
    gt_q = quat.qnormalize(torch.as_tensor(rng.normal(size=4), dtype=torch.float32))
    clean = render_depth(torch.as_tensor(mesh.vertices), torch.as_tensor(mesh.faces), cam,
                         torch.as_tensor(gt_t), gt_q).numpy()
    obs = np.where(clean > 0, clean + 0.01 * rng.normal(size=clean.shape), 0.0)
    exp = Experiment(scene={"camera": cam, "verts": mesh.vertices, "faces": mesh.faces},
                     prior_o=params.o_mask_is, prior_t=gt_t,
                     depth_image=torch.as_tensor(obs, dtype=torch.float32))
    posterior = fused_posterior(params, exp, "association", device="cpu")
    return posterior, smc_mh(params, posterior)


def _resampling_log(smc):
    """Record the whole population's resampling indices of every step: the
    sharded ``systematic_resampling_indices`` computes them on the gathered
    weights by calling itself without a shard."""
    inner = smc.systematic_resampling_indices
    calls = []

    def logged(log_weights, u, shard=None):
        idx = inner(log_weights, u, shard)
        if shard is None:
            calls.append(idx)
        return idx

    smc.systematic_resampling_indices = logged
    return calls


def _worker(rank, world, store, out_dir, task):
    os.environ["GLOO_SOCKET_IFNAME"] = "lo"
    torch.set_num_threads(1)
    from bayesianposeestimation.jl_tpu_torch.parallel.sharded import (
        particle_group,
        sharded_sample_chain,
    )
    from bayesianposeestimation.jl_tpu_torch.samplers import smc

    group = particle_group("cpu", init_method=f"file://{store}", rank=rank, world_size=world)
    try:
        out = {}
        if task == "chain":
            posterior, sampler = cube_model()
            calls = _resampling_log(smc)
            outs, final = sharded_sample_chain(SEED, posterior, sampler, N_STEPS, N_PARTICLES,
                                               group)
            out = {**{k: v.numpy() for k, v in outs.items()},
                   "final_t": final.sample.variables["t"].numpy(),
                   "final_ll": final.sample.log_like.numpy(),
                   "final_w": final.log_weights.numpy(),
                   "resampling": np.stack([c.numpy() for c in calls])}
        elif task == "chi2":
            shard = smc.ParticleShard(group, rank, world, 64)
            w = _chi2_weights()
            local = shard.rows(torch.log(torch.as_tensor(w, dtype=torch.float32)))
            gen = torch.Generator().manual_seed(3)
            idx = [shard.gather(smc.systematic_resampling_indices(
                local, torch.rand((), generator=gen), shard)) for _ in range(CHI2_REPS)]
            out = {"idx": torch.stack(idx).numpy()}
        elif task == "indivisible":
            posterior, sampler = cube_model()
            try:
                sharded_sample_chain(SEED, posterior, sampler, 2, 30, group)
                out = {"raised": np.asarray(False)}
            except ValueError as e:
                out = {"raised": np.asarray(True), "message": np.asarray(str(e))}
        np.savez(os.path.join(out_dir, f"{task}_{world}_{rank}.npz"), **out)
    finally:
        import torch.distributed as dist

        dist.destroy_process_group()


def run_world(tmp_path, world, task):
    """``task`` in ``world`` processes; every rank's result."""
    store = tmp_path / f"store_{task}_{world}"
    mp.spawn(_worker, args=(world, str(store), str(tmp_path), task), nprocs=world, join=True)
    return [dict(np.load(tmp_path / f"{task}_{world}_{r}.npz")) for r in range(world)]


def _chi2_weights():
    rng = np.random.default_rng(5)
    w = rng.dirichlet(np.full(64, 0.5))
    return w / w.sum()


@pytest.fixture(scope="module")
def chains(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sharded")
    return {world: run_world(tmp, world, "chain") for world in (1, 2, 4)}


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_chain_matches_one_process(chains, world):
    ref = chains[1][0]
    gaps = {}
    for rank, got in enumerate(chains[world]):
        # every rank holds the whole gathered population and the same trace
        np.testing.assert_array_equal(got["log_evidence"], chains[world][0]["log_evidence"])
        np.testing.assert_allclose(got["log_evidence"], ref["log_evidence"], **TOL)
        np.testing.assert_array_equal(got["resampling"], ref["resampling"])
        np.testing.assert_allclose(np.sort(got["final_ll"]), np.sort(ref["final_ll"]), **TOL)
        np.testing.assert_allclose(got["final_t"][got["final_ll"].argmax()],
                                   ref["final_t"][ref["final_ll"].argmax()], atol=BEST_T_ATOL)
        assert got["t"].shape == (N_STEPS - 1, N_PARTICLES, 3)
        gaps[rank] = float(np.abs(got["log_evidence"] - ref["log_evidence"]).max())
    print(f"world {world}: max evidence gap to one process {max(gaps.values()):.3g}, "
          f"{len(ref['resampling'])} resampling calls")


def test_one_process_shard_equals_sample_chain(chains):
    """World size 1 against the unsharded ``sample_chain`` in this process."""
    from bayesianposeestimation.jl_tpu_torch.samplers.chain import sample_chain

    posterior, sampler = cube_model()
    outs, final = sample_chain(SEED, posterior, sampler, N_STEPS, N_PARTICLES, device="cpu")
    got = chains[1][0]
    for key, value in outs.items():
        np.testing.assert_array_equal(got[key], value.numpy(), err_msg=key)
    np.testing.assert_array_equal(got["final_t"], final.sample.variables["t"].numpy())
    np.testing.assert_array_equal(got["final_w"], final.log_weights.numpy())


def test_sharded_resampling_counts_match_weights(tmp_path):
    """tests/test_multichip.py:171-202 over 4 processes: the gathered indices
    of every process are the same, and their offspring counts fit the
    weights."""
    ranks = run_world(tmp_path, 4, "chi2")
    idx = ranks[0]["idx"]
    for r in ranks[1:]:
        np.testing.assert_array_equal(r["idx"], idx)
    w = _chi2_weights()
    n = w.size
    counts = np.bincount(idx.ravel(), minlength=n).astype(np.float64)
    expected = CHI2_REPS * n * w
    keep = expected >= 5
    chi2 = float((((counts - expected) ** 2 / expected)[keep]).sum())
    df = int(keep.sum()) - 1
    assert chi2 < df + 3.1 * np.sqrt(2 * df), (chi2, df)
    z = np.abs(counts - expected) / np.sqrt(0.25 * CHI2_REPS)
    assert z.max() < 4.0, z.max()


def test_indivisible_particle_count_raises(tmp_path):
    for r in run_world(tmp_path, 4, "indivisible"):
        assert bool(r["raised"]), r
        assert "do not split evenly" in str(r["message"])


def test_shard_state_and_sampler():
    from bayesianposeestimation.jl_tpu_torch.parallel.sharded import (
        backend_for,
        shard_sampler,
        shard_state,
    )
    from bayesianposeestimation.jl_tpu_torch.samplers.mh import MetropolisHastings
    from bayesianposeestimation.jl_tpu_torch.samplers.smc import SmcState
    from bayesianposeestimation.jl_tpu_torch.samples import Sample

    state = SmcState(Sample({"t": torch.arange(24.0).reshape(8, 3)}, torch.zeros(8),
                            torch.arange(8.0)),
                     torch.full((8,), -np.log(8.0)), torch.tensor(1.5), torch.tensor(0.5),
                     torch.tensor(-0.1))
    part = shard_state(state, 1, 4)
    np.testing.assert_array_equal(part.sample.variables["t"].numpy(),
                                  [[6, 7, 8], [9, 10, 11]])
    np.testing.assert_array_equal(part.sample.log_like.numpy(), [2, 3])
    assert float(part.log_evidence) == 1.5
    with pytest.raises(ValueError, match="do not split evenly"):
        shard_state(state, 0, 3)
    _, sampler = cube_model()
    sharded = shard_sampler(sampler, "a shard")
    assert all(s.shard == "a shard" for s in sharded.samplers)
    assert all(s.shard is None for s in sampler.samplers)
    with pytest.raises(TypeError, match="no particle axis"):
        shard_sampler(MetropolisHastings(None, None), "a shard")
    assert backend_for("cuda:0") == "nccl" and backend_for("cpu") == "gloo"


def test_shard_configs():
    configs = list(range(10))
    shards = [shard_configs(configs, w, 3) for w in range(3)]
    assert sorted(sum(shards, [])) == configs
    assert shards[0] == [0, 3, 6, 9]


def test_shard_configs_from_the_environment(monkeypatch):
    monkeypatch.setenv("WORKER", "1")
    monkeypatch.setenv("N_WORKERS", "4")
    assert shard_configs(list(range(10))) == [1, 5, 9]
    monkeypatch.delenv("WORKER")
    monkeypatch.delenv("N_WORKERS")
    assert shard_configs(list(range(3))) == [0, 1, 2]


def test_run_sweep_caches_and_collect_results(tmp_path):
    calls = []

    def fn(config):
        calls.append(config)
        return {"v": np.asarray([config["x"]])}

    configs = [{"x": i} for i in range(4)]
    out = run_sweep(fn, configs, tmp_path, worker=0, n_workers=2, log=lambda *a: None)
    assert len(out) == 2 and len(calls) == 2
    run_sweep(fn, configs, tmp_path, worker=0, n_workers=2, log=lambda *a: None)
    assert len(calls) == 2  # cached
    run_sweep(fn, configs, tmp_path, worker=1, n_workers=2, log=lambda *a: None)
    results = collect_results(tmp_path)
    assert [r["__config__"] for r in results] == [{"x": i} for i in range(4)]
    assert [int(r["v"][0]) for r in results] == [0, 1, 2, 3]
    assert [os.path.basename(r["__path__"]) for r in results] == \
        [savename({"x": i}) + ".npz" for i in range(4)]
