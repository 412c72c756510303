from .chain import collect_variables, sample_chain, smc_inference
from .composed import ComposedSampler, CoordinateSampler
from .gibbs import Gibbs
from .mh import MCMCState, MetropolisHastings, acceptance_ratio, mh_kernel, select_sample
from .mtm import MtmState, MultipleTry, gumbel_index, gumbel_noise
from .smc import (
    AdaptiveKernel,
    BootstrapKernel,
    ForwardProposalKernel,
    MhKernel,
    SequentialMonteCarlo,
    SmcState,
    adaptive_deltas,
    log_relative_ess,
    logevidence,
    maybe_resample,
    normalize_log_weights,
    resample_systematic,
    systematic_resampling_indices,
)
