"""The SMC population update after the likelihood (``samplers/smc.py``
``update_population``): reweight, evidence, log(ESS/N), systematic
resampling and its select per field.

On the card it is one kernel (``ops/smc_update.py``, ``csrc/smc_update.cu``);
for CPU tensors and for a sharded step it is the plain version
(``update_population_plain``), the code the step always ran. On the CPU these
tests hold the plain version bitwise to that code written out, check where
the update goes (a sharded step never reaches the kernel's wrapper), the
wrapper's argument checks and the constants the kernel mirrors, that the
fields every SMC sampler hands the update pass those checks, and the
comparison ``chip_smoke.py``'s phase 19 makes, on the plain version with
planted faults. The tests marked ``card`` need a CUDA card and skip without
one: the kernel against the plain version on the same tensors
(``parity_cases.compare_smc_update``) and captured chains and filters bitwise
against their eager loops with the kernel in both. Run them on the card with
``python3 -m pytest tests/test_torch_smc_update.py -m card --noconftest -p
no:cacheprovider`` (this file imports no JAX; the suite's conftest does).
"""

import math
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import parity_cases
from bayesianposeestimation.jl_tpu_torch import capture, convert, telemetry
from bayesianposeestimation.jl_tpu_torch.models import experiment_samplers as TES
from bayesianposeestimation.jl_tpu_torch.models import particle_filter as TPF
from bayesianposeestimation.jl_tpu_torch.models.fused import fused_posterior
from bayesianposeestimation.jl_tpu_torch.ops import cuda_raster
from bayesianposeestimation.jl_tpu_torch.ops import smc_update as ops_update
from bayesianposeestimation.jl_tpu_torch.samplers import sample_chain, smc
from bayesianposeestimation.jl_tpu_torch.samples import Sample
from bayesianposeestimation.jl_tpu_torch.utils import mesh_io
from portbench.trace import RASTER_KERNELS

CASES = parity_cases.SMC_UPDATE_CASES
SHAPES = [(1, "bop"), (31, "tracker"), (100, "bop"), (600, "tracker")]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the update kernel has no CPU form")
    return "cuda"


def _posterior(device, n_particles=8):
    """A 10 cm cube 1 m away behind a 16x16 camera, observed with noise, and
    its parameters."""
    params = convert.parameters_from_fields(
        width=16, height=16, n_particles=n_particles, n_steps=7,
        proposal_sigma_r=(0.5, 0.5, 0.5), device=device)
    mesh = mesh_io.cube_mesh(0.1)
    cam = convert.camera_from_fields(width=16, height=16, f_x=20.0, f_y=20.0, c_x=7.5,
                                     c_y=7.5, near=0.01, far=10.0)
    t = torch.tensor([[0.01, -0.02, 1.0]])
    q = torch.tensor([[0.9, 0.1, 0.3, -0.2]])
    clean = cuda_raster.render_depth(torch.as_tensor(mesh.vertices, dtype=torch.float32),
                                     torch.as_tensor(mesh.faces, dtype=torch.int32), cam, t,
                                     q / q.norm(), device="cpu")[0]
    noise = 0.005 * torch.randn(clean.shape, generator=torch.Generator().manual_seed(0))
    obs = torch.where(clean > 0, clean + noise, torch.zeros_like(clean)).numpy()
    exp = convert.experiment_from_numpy(cam, mesh.vertices, mesh.faces, 0.7,
                                        t[0].numpy() + 0.01, obs)
    return params, fused_posterior(params, exp, "association", device=device)


def _stream(device, n_frames=5):
    """A 10 cm cube drifting over ``n_frames`` 24x24 frames, 4 mm depth noise,
    and the filters' parameters (24 particles)."""
    mesh = mesh_io.cube_mesh(0.1)
    cam = convert.camera_from_fields(width=24, height=24, f_x=28.8, f_y=28.8, c_x=11.5,
                                     c_y=11.5, near=0.01, far=10.0)
    s = torch.linspace(0, 1, n_frames)[:, None]
    t = torch.tensor([[0.0, 0.0, 1.0]]) + s * torch.tensor([[0.03, -0.02, 0.04]])
    q = torch.cat([torch.ones(n_frames, 1), 0.15 * s, torch.zeros(n_frames, 1), 0.05 * s], 1)
    clean = cuda_raster.render_depth(torch.as_tensor(mesh.vertices, dtype=torch.float32),
                                     torch.as_tensor(mesh.faces, dtype=torch.int32), cam, t,
                                     q / q.norm(dim=1, keepdim=True), device="cpu").numpy()
    noisy = np.where(clean > 0, clean + np.random.default_rng(0).normal(0, 0.004, clean.shape),
                     0.0).astype(np.float32)
    exp = convert.experiment_from_numpy(cam, mesh.vertices, mesh.faces, 0.7, t[0].numpy(),
                                        noisy[0])
    params = convert.parameters_from_fields(
        width=24, height=24, n_particles=24, relative_ess=0.5,
        proposal_sigma_t=(0.005, 0.005, 0.005), proposal_sigma_r=(0.05, 0.05, 0.05),
        device=device)
    return params, exp, convert.stream_from_numpy(noisy, device)


def _equal(a, b):
    sa, la = capture.tree_leaves(a)
    sb, lb = capture.tree_leaves(b)
    assert sa == sb
    for x, y in zip(la, lb):  # bitwise, NaN where NaN
        assert torch.equal(x, y) or torch.allclose(x, y, rtol=0, atol=0, equal_nan=True)


def _update(inp, fn=smc.update_population_plain):
    old, sample = parity_cases.smc_update_state(inp)
    temp = torch.ones(())
    return fn(old, inp["incr"], sample, temp, inp["u"], inp["threshold"])


# -- the plain version ---------------------------------------------------------


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("n,field_set", SHAPES)
def test_plain_update_equals_the_step_sequence(n, field_set, case):
    """``update_population_plain`` and, for CPU tensors, ``update_population``
    are bitwise the sequence ``SequentialMonteCarlo.step`` ran before the
    update had a name: new weights, evidence, ``normalize_log_weights``,
    ``log_relative_ess``, ``maybe_resample``."""
    inp = parity_cases.smc_update_inputs("cpu", n, field_set, case)
    old, sample = parity_cases.smc_update_state(inp)
    temp = torch.ones(())
    new_weights = old.log_weights + inp["incr"]
    new_evidence = old.log_evidence + torch.logsumexp(new_weights, dim=-1)
    normalized = smc.normalize_log_weights(new_weights)
    state = smc.SmcState(sample, normalized, new_evidence, temp,
                         smc.log_relative_ess(normalized))
    expected = smc.maybe_resample(inp["u"], state, inp["threshold"])
    _equal(_update(inp), expected)
    _equal(_update(inp, smc.update_population), expected)


@pytest.mark.parametrize("fault", ["none", "weights", "evidence", "ess", "decision", "row",
                                   "index"])
def test_phase19_comparison_sees_planted_faults(fault):
    """``parity_cases.compare_smc_update`` on the CPU with the plain version in
    the kernel's place: it passes the plain version, and fails a weight,
    the evidence or the ESS moved by ten tolerances, a flipped resampling
    decision, a field row taken from another particle, an index moved away
    from the cdf's steps."""
    inp = parity_cases.smc_update_inputs("cpu", 600, "tracker", "random")
    plain = parity_cases.smc_update_plain(inp)
    state, idx = plain[0], plain[1]
    assert bool(state.log_relative_ess < inp["threshold"])  # this input resamples
    lw, ev, ess = state.log_weights.clone(), state.log_evidence.clone(), state.log_relative_ess
    fields = [f.clone() for f in (*state.sample.variables.values(), state.sample.log_prob,
                                  state.sample.log_like)]
    idx = idx.clone()
    move = 10 * parity_cases.SMC_UPDATE_TOL * parity_cases.smc_update_scale(inp)
    if fault == "weights":
        lw[3] += move
    elif fault == "evidence":
        ev = ev + move
    elif fault == "ess":
        ess = ess + move
    elif fault == "decision":
        ess = torch.tensor(inp["threshold"] + 1.0)
    elif fault == "row":
        fields[0][5] = inp["fields"][0][(idx[5] + 1) % 600]
    elif fault == "index":
        idx[7] = (idx[7] + 300) % 600
    res = parity_cases.compare_smc_update(inp, (lw, ev, ess, fields, idx), plain)
    assert res["ok"] == (fault == "none"), res


# -- where the update goes -----------------------------------------------------


def test_dispatch_by_device_and_shard(monkeypatch):
    """An unsharded update of tensors off the CPU goes to the kernel's wrapper;
    a sharded one (collectives) to the plain version on any device; each
    counts its path once."""
    calls, seen = [], []
    monkeypatch.setattr(smc, "smc_update", lambda *a, **kw: calls.append("kernel") or (
        None, None, None, [None] * 4))
    monkeypatch.setattr(smc, "update_population_plain", lambda *a, **kw: calls.append("plain"))
    fake = types.SimpleNamespace(device=torch.device("cuda"))
    sample = Sample({"t": None, "r": None}, None, None)
    old = smc.SmcState(sample, None, None, None, None)
    shard = smc.ParticleShard(None, 0, 1, 4)
    def listen(key, n):
        seen.append(key)

    telemetry.add_listener(listen)
    try:
        smc.update_population(old, fake, sample, None, None, -0.7)
        smc.update_population(old, fake, sample, None, None, -0.7, shard)
        smc.update_population(old, torch.zeros(4), sample, None, None, -0.7)
    finally:
        telemetry.remove_listener(listen)
    assert calls == ["kernel", "plain", "plain"]
    paths = [k for k in seen if k[0] == "smc_update_path"]
    assert paths == [("smc_update_path", "kernel"), ("smc_update_path", "plain"),
                     ("smc_update_path", "plain")]


def test_sharded_step_never_reaches_the_wrapper(monkeypatch):
    """A sharded ``smc_mh`` chain (one process, collectives as identities)
    runs every update through the plain version: the wrapper, patched to
    raise, is never called, and each step counts the plain path."""
    def refused(*a, **kw):
        raise AssertionError("a sharded step reached the kernel's wrapper")

    def all_gather(parts, x, group=None):
        parts[0].copy_(x)

    monkeypatch.setattr(smc, "smc_update", refused)
    monkeypatch.setattr(smc.dist, "all_reduce", lambda x, op=None, group=None: None)
    monkeypatch.setattr(smc.dist, "all_gather", all_gather)
    from bayesianposeestimation.jl_tpu_torch.parallel.sharded import shard_sampler

    params, post = _posterior("cpu")
    sampler = shard_sampler(TES.smc_mh(params, post), smc.ParticleShard(None, 0, 1, 8))
    seen = []

    def listen(key, n):
        seen.append(key)

    telemetry.add_listener(listen)
    try:
        sample_chain(0, post, sampler, 6, 8, device="cpu", captured=False)
    finally:
        telemetry.remove_listener(listen)
    assert [k for k in seen if k[0] == "smc_update_path"] == [("smc_update_path", "plain")] * 5


# -- the wrapper ---------------------------------------------------------------


def _wrapper_args(n=8, width=3):
    f = torch.float32
    return [torch.zeros(n, dtype=f), torch.zeros(n, dtype=f), torch.zeros((), dtype=f),
            torch.full((), 0.5, dtype=f), [torch.zeros((n, width), dtype=f),
                                           torch.zeros(n, dtype=f)], math.log(0.5)]


BAD = {
    "float64 weights": (lambda a: a.__setitem__(0, a[0].double()), TypeError),
    "incr of another length": (lambda a: a.__setitem__(1, a[1][:5]), ValueError),
    "evidence not a scalar": (lambda a: a.__setitem__(2, a[2][None]), ValueError),
    "non-contiguous field": (lambda a: a[4].__setitem__(0, torch.zeros(3, 8).t()), ValueError),
    "field of another length": (lambda a: a[4].__setitem__(1, torch.zeros(9)), ValueError),
    "empty field rows": (lambda a: a[4].__setitem__(0, torch.zeros(8, 0)), ValueError),
    "threshold on a device": (lambda a: a.__setitem__(5, torch.tensor(-0.7)), TypeError),
    "too many fields": (lambda a: a.__setitem__(4, [torch.zeros(8)] * 17), ValueError),
    "too many particles": (lambda a: a.__setitem__(0, torch.zeros(ops_update.MAX_PARTICLES + 1)),
                           ValueError),
    "no particles": (lambda a: a.__setitem__(0, torch.zeros(0)), ValueError),
}


@pytest.mark.parametrize("bad", list(BAD))
def test_wrapper_refuses_what_the_kernel_does_not_take(bad):
    args = _wrapper_args()
    change, error = BAD[bad]
    change(args)
    with pytest.raises(error):
        ops_update.smc_update(*args)


def test_wrapper_runs_no_plain_version_for_cpu_tensors():
    """Valid CPU tensors raise: the kernel has no quiet fallback."""
    args = _wrapper_args()
    assert ops_update.check_inputs(*args) == 8
    before = ops_update.smc_update.launches
    with pytest.raises(ValueError, match="unsupported device"):
        ops_update.smc_update(*args)
    assert ops_update.smc_update.launches == before


def test_kernel_source_mirrors_the_wrapper():
    """The limits the wrapper checks are the kernel's, and at the most
    particles the block's shared memory (the weights and their cdf, 2 x 4
    bytes a particle, beside the static scratch of one float a warp) fits
    the 48 KB a launch gets without an attribute call; the kernel is built
    in the raster kernels' library (one nvcc run); its name is no name the
    benchmark's trace counts as ``render_score``'s."""
    src = (Path(cuda_raster.__file__).resolve().parents[1] / "csrc" / "smc_update.cu")
    text = src.read_text()

    def constant(name):
        line = next(x for x in text.splitlines() if f"constexpr int {name} =" in x)
        return int(line.split("=")[1].split(";")[0].split("//")[0])

    assert constant("kMaxParticles") == ops_update.MAX_PARTICLES
    assert constant("kMaxFields") == ops_update.MAX_FIELDS
    static = [x.strip() for x in text.splitlines()
              if "__shared__" in x and "extern" not in x]
    assert static == ["__shared__ float scratch[kWarps];"]
    assert constant("kMaxThreads") == 1024
    warps = constant("kMaxThreads") // 32
    assert 2 * 4 * ops_update.MAX_PARTICLES + 4 * warps <= 48 * 1024
    assert src in cuda_raster._SOURCES
    assert "smc_update_kernel" in text
    assert not any(k in "smc_update_kernel" for k in RASTER_KERNELS)


@pytest.mark.parametrize("name", ["smc_mh", "smc_forward", "smc_bootstrap", "coordinate_pf",
                                  "bootstrap_pf"])
def test_every_sampler_hands_the_update_what_the_kernel_takes(name, monkeypatch):
    """Every SMC sampler's updates, run on the CPU, pass the wrapper's
    argument checks: f32, contiguous rows, one device, a host threshold."""
    plain = smc.update_population_plain
    checked = []

    def checking(old, incr, new_sample, new_temp, u, threshold, shard=None):
        fields = [*new_sample.variables.values(), new_sample.log_prob, new_sample.log_like]
        checked.append(ops_update.check_inputs(old.log_weights, incr, old.log_evidence, u,
                                               fields, threshold))
        return plain(old, incr, new_sample, new_temp, u, threshold, shard)

    monkeypatch.setattr(smc, "update_population_plain", checking)
    if name.endswith("_pf"):
        params, exp, depth = _stream("cpu")
        pf = TPF.coordinate_pf if name == "coordinate_pf" else TPF.bootstrap_pf
        pf(0, TPF.fused_pf_posterior("simple"), params, exp, depth, device="cpu",
           captured=False)
        n = params.n_particles
    else:
        params, post = _posterior("cpu")
        sample_chain(0, post, getattr(TES, name)(params, post), 5, 8, device="cpu",
                     captured=False)
        n = 8
    assert checked and set(checked) == {n}


# -- on the card -------------------------------------------------------------


@pytest.mark.card
@pytest.mark.parametrize("field_set", list(parity_cases.SMC_UPDATE_FIELDS))
@pytest.mark.parametrize("n", parity_cases.SMC_UPDATE_SIZES)
def test_kernel_matches_the_plain_version_on_the_card(card, n, field_set):
    """Phase 19's comparison (``parity_cases.smc_update_cases``): the kernel
    against the plain version on the same card tensors in every case of
    ``parity_cases.SMC_UPDATE_CASES``: weights, evidence and ESS within 1e-6
    of the inputs' largest magnitude, indices equal but where a position
    lies within 2^-20 of the plain cdf, fields bitwise."""
    for case, res in parity_cases.smc_update_cases(card, n, field_set):
        assert res["ok"], (case, res)


@pytest.mark.card
def test_captured_smc_mh_chain_equals_eager_on_the_card(card):
    """A captured ``smc_mh`` chain (its updates replayed from CUDA graphs) is
    bitwise the eager loop, both through the kernel, one launch a step."""
    params, post = _posterior(card, n_particles=100)
    sampler = TES.smc_mh(params, post)
    before = ops_update.smc_update.launches
    eager = sample_chain(0, post, sampler, 40, 100, device=card, captured=False)
    assert ops_update.smc_update.launches - before == 39
    captured = sample_chain(0, post, sampler, 40, 100, device=card)
    _equal(captured, eager)
    assert ops_update.smc_update.launches - before == 78


@pytest.mark.card
@pytest.mark.parametrize("kind", ["bootstrap", "coordinate"])
def test_captured_filter_equals_eager_on_the_card(card, kind):
    """Both filters captured against their eager frame loop on the card,
    bitwise, every update through the kernel (two a frame for the
    coordinate filter)."""
    params, exp, depth = _stream(card)
    pf = TPF.coordinate_pf if kind == "coordinate" else TPF.bootstrap_pf
    before = ops_update.smc_update.launches
    eager = pf(0, TPF.fused_pf_posterior("simple"), params, exp, depth, device=card,
               captured=False)
    per_frame = 2 if kind == "coordinate" else 1
    assert ops_update.smc_update.launches - before == per_frame * (depth.shape[0] - 1)
    captured = pf(0, TPF.fused_pf_posterior("simple"), params, exp, depth, device=card)
    _equal(captured, eager)
