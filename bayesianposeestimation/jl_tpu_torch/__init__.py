"""PyTorch/CUDA port of the pose-estimation framework (``jl_tpu``'s counterpart).

The layout mirrors ``bayesianposeestimation.jl_tpu`` module for module, so
each function's reference is found under the same name there. The JAX package
stays the reference: the port imports neither JAX nor anything of it, and its
tests hold each module against its JAX counterpart on the same inputs.

The public names of ``jl_tpu/__init__.py`` are re-exported here, each from
the port module that matches the JAX one, so::

    import bayesianposeestimation.jl_tpu_torch as bpt

    bpt.smc_mh, bpt.fused_posterior, bpt.sample_chain, bpt.cuda_render_score

``JAX_COUNTERPARTS`` says what stands in for each JAX name that has no
same-named counterpart. ``render_depth`` and ``render_depth_batch`` are the
dense rasteriser of ``ops/rasterize.py``, as in the JAX package; the
hand-written kernels are ``cuda_render_score`` and ``cuda_render_depth``.

Entry points (``fused_posterior``, the graph posteriors' priors
``point_prior`` / ``pf_prior``, ``sample_chain``, ``coordinate_pf`` /
``bootstrap_pf``, ``ops.cuda_raster.render_score`` and ``render_depth``, the
BOP sweep ``scripts/torch_smc_bop_val.py`` and the demo
``scripts/torch_demo_inference.py``) take a ``device`` that defaults to
``"cuda"``; the CPU is used only when the caller
asks for it, and a request for ``"cuda"`` without a card raises. The
hand-written kernels (``csrc/render_score.cu``: the fused render+score with
its epilogues and its depth-image forms) are built with ``nvcc`` at their
first CUDA launch; importing the package needs neither CUDA, nor a compiler,
nor matplotlib.
"""

from . import (
    bijectors,
    camera,
    common,
    distributions,
    function_manipulation,
    graph,
    posterior,
    proposals,
    quaternions,
    render,
    samples,
    samplers,
    tempering,
)
from .bijectors import IDENTITY, LOG, LOGIT
from .camera import CvCamera, crop_camera, crop_image, depth_to_distance, reproject_3d
from .common import (
    add_logdensity,
    map_intersect,
    norm_dims,
    normalize_dims,
    pose_matrix,
    quat_dist,
    sum_and_dropdims,
    to_cpu,
    to_pose_matrix,
)
from .distributions import (
    BinaryMixture,
    Dirac,
    Exponential,
    Gumbel,
    MvNormal,
    Normal,
    QuaternionNormal,
    QuaternionUniform,
    SmoothExponential,
    TailUniform,
    TruncatedExponential,
    Uniform,
)
from .function_manipulation import ManipulatedFunction, pipeable
from .graph import (
    BroadcastedNode,
    DeterministicNode,
    ModifierNode,
    sequentialize,
)
from .models import experiment_models, experiment_samplers, particle_filter, pixel
from .models.experiment_models import (
    association_posterior,
    association_simple_reg,
    point_from_segmentation,
    point_prior,
    simple_posterior,
    smooth_posterior,
    smooth_simple_posterior,
    smooth_simple_reg,
)
from .models.experiment_samplers import (
    mh_local_sampler,
    mh_sampler,
    mtm_local_sampler,
    mtm_sampler,
    smc_bootstrap,
    smc_forward,
    smc_mh,
)
from .models.fused import FusedPosterior, fused_posterior, make_conditioned_chain
from .models.particle_filter import (
    Dynamics,
    JointDynamics,
    bootstrap_pf,
    coordinate_pf,
    fused_pf_posterior,
    pf_prior,
    pf_prior_nodes,
)
from .models.pixel import (
    image_likelihood_normalizer,
    marginalized_association,
    pixel_association_fn,
    pixel_mixture,
    pixel_tail,
    simple_image_regularization,
    smooth_association_fn,
    smooth_mixture,
    smooth_tail,
    truncated_association_fn,
    truncated_mixture,
    truncated_tail,
)
from .ops.cuda_raster import render_depth as cuda_render_depth
from .ops.cuda_raster import render_score as cuda_render_score
from .ops.rasterize import render_depth, render_depth_batch
from .parameters import Experiment, Parameters
from .posterior import PosteriorModel, retemper, tempered_logdensity
from .proposals import (
    Proposal,
    additive_proposal,
    independent_proposal,
    propose,
    symmetric_proposal,
    transition_probability,
)
from .quaternions import (
    qconj,
    qexp,
    qlog,
    qminus,
    qmul,
    qnormalize,
    qplus,
    qrotate,
    quat_identity,
    quat_to_matrix,
    rand_quaternion,
)
# as in jl_tpu, the function render.render shadows the module of that name
from .render import RenderContext, render, render_context, render_crop_fn, render_fn
from .samples import Sample, sample_minus, sample_plus, to_model_domain, to_unconstrained_domain
from .samplers import (
    AdaptiveKernel,
    BootstrapKernel,
    ComposedSampler,
    CoordinateSampler,
    ForwardProposalKernel,
    Gibbs,
    MCMCState,
    MetropolisHastings,
    MhKernel,
    MultipleTry,
    SequentialMonteCarlo,
    SmcState,
    collect_variables,
    logevidence,
    sample_chain,
    smc_inference,
)
from .tempering import ConstantSchedule, ExponentialSchedule, LinearSchedule

#: Names of ``jl_tpu`` (module path under the package, then the name) that
#: have no same-named counterpart here, and what stands in for each: a name
#: of this package, or None for a JAX- or Pallas-only helper.
JAX_COUNTERPARTS = {
    # the Pallas TPU kernels: the hand-written CUDA kernels of csrc/render_score.cu
    "ops.pallas_raster": "ops.cuda_raster",
    "ops.pallas_raster.pallas_render_depth": "cuda_render_depth",
    "ops.pallas_raster.pallas_render_score": "cuda_render_score",
    # Pallas tiling and layout helpers: face chunks, tile order, the paired
    # face layout and its lane constants (the CUDA launch plan is
    # ops.cuda_raster.launch_plan)
    "ops.pallas_raster.resolve_chunk": None,
    "ops.pallas_raster.spatial_sort_faces": None,
    "ops.pallas_raster.antipodal_pair_faces": None,
    "ops.pallas_raster.expand_triangle_rows": None,
    "ops.pallas_raster.paired_layout_ok": None,
    "ops.pallas_raster.LANE": None,
    "ops.pallas_raster.N_FORMS": None,
    "ops.pallas_raster.MAX_KERNEL_SIDE": None,
    "ops.pallas_raster.POSE_BLOCK": None,
    # a jax.sharding.Mesh and its axis name: the port shards particles over
    # a torch.distributed group
    "parallel.sharded.particle_mesh": "parallel.sharded.particle_group",
    "parallel.sharded.PARTICLE_AXIS": None,
    # a JAX PRNG key: the port seeds torch.Generators from Parameters.seed
    "parameters.Parameters.key": "rngs.Rngs.from_seed",
}

__version__ = "0.1.0"
