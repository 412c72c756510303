// Two kernels of the sampler step, written by hand for Hopper (sm_90a): the
// SMC population update after the likelihood, and before it the MH move's
// tail after the render (mh_move_kernel, below the update), one launch each.
//
// The population update.
//
// Replaces no TPU kernel: the JAX step (jl_tpu/samplers/smc.py,
// SequentialMonteCarlo.step from the new weights through maybe_resample) is
// plain jnp that XLA fuses into a few fusions. The port ran the same code as
// plain PyTorch, 77-81 small kernels a step on an H100 (four logsumexps of
// ~9 launches, cumsum, searchsorted, a gather and a torch.where per field),
// each doing almost nothing over 100-1,250 floats; this kernel takes their
// place: 5-14 us of device time against 0.10-0.14 ms (100-1,250 particles,
// both replayed from CUDA graphs).
//
// What it computes, in fp32, exactly as samplers/smc.py's plain version
// (update_population_plain) does, up to the order of its sums:
//   1. w = old log-weights + incr; lse = logsumexp(w) with torch's rules (the
//      maximum, NaN propagating, shifts by 0 where it is +-inf); the new
//      evidence old + lse; the normalized weights w - lse where lse is
//      finite, else w; log(ESS/N) = -logsumexp(2 w_norm) - log N;
//   2. systematic resampling (systematic_resampling_indices): normalize
//      again, exponentiate, uniform weights where all are 0, an inclusive
//      scan divided by its last entry, and for particle i the first position
//      of the cdf at or above (u + i) * (1/N) (torch.searchsorted's
//      side="left" loop, including its NaN rule; the reciprocal is how the
//      card's torch divides by a host number), clamped to [0, N);
//   3. do = log(ESS/N) < threshold; each field's row i is do ? row idx_i :
//      row i, the log-weights do ? -log N : normalized (maybe_resample).
// The fields (the sample's variables, log_prob, log_like) come as a table of
// (source, destination, width); the outputs are fresh tensors, never the
// inputs, since the gathers read the inputs.
//
// Design. One block over the particle axis (up to 1,024 threads,
// ceil(N / 1,024) particles a thread in the scan): the work is ~10 floats a
// particle, so what bounds it is the launch and the block's barriers, not
// bytes (a few tens of KB) or operations. The maxima of the second and third
// logsumexp need no reduction: subtracting a finite lse and doubling are
// monotone, so max(2 (w - lse)) = 2 (max w - lse) exactly. "All weights are
// 0" is "the scan's total is 0" (a sum of non-negative floats is 0 only if
// every term is; NaN and inf are not 0). Sums are taken per thread, across a
// warp by shuffles, then across warps in a fixed order: a launch repeats bit
// for bit, so a captured step equals its eager run. Built with -fmad=false
// beside render_score.cu (one nvcc run for both), so no product and sum is
// contracted where the plain version rounds twice.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxFields = 16;  // mirrored in ops/smc_update.py
constexpr int kMaxThreads = 1024;
constexpr int kWarps = kMaxThreads / 32;
// mirrored in ops/smc_update.py: 2 x 4 B a particle of dynamic shared memory
// beside the static `scratch` (kWarps floats), within the 48 KB a launch gets
// without an attribute call
constexpr int kMaxParticles = 6128;
static_assert(2 * sizeof(float) * kMaxParticles + sizeof(float) * kWarps <= 48 * 1024,
              "the weights, their cdf and the scratch exceed 48 KB of shared memory");

struct Fields {
  const float* src[kMaxFields];
  float* dst[kMaxFields];
  int width[kMaxFields];
  int count;
};

// torch.amax's maximum: a NaN wins
struct NanMax {
  __device__ __forceinline__ float operator()(float a, float b) const {
    return (isnan(a) || a > b) ? a : b;
  }
};

struct Add {
  __device__ __forceinline__ float operator()(float a, float b) const { return a + b; }
};

// logsumexp's shift: the maximum, or 0 where it is +-inf
__device__ __forceinline__ float shift_of(float m) {
  return fabsf(m) == INFINITY ? 0.0f : m;
}

// The block's reduction of one value a thread; every thread gets the result.
// `scratch` holds kWarps floats and is free again on return.
template <class Op>
__device__ float block_reduce(float v, Op op, float* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int o = 16; o > 0; o >>= 1) v = op(v, __shfl_xor_sync(0xffffffffu, v, o));
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  v = scratch[0];
  const int warps = blockDim.x >> 5;
  for (int w = 1; w < warps; ++w) v = op(v, scratch[w]);
  __syncthreads();
  return v;
}

// Inclusive scan of x[0, n) in place, thread t owning [t k, t k + k); returns
// the total (x[n - 1]) to every thread.
__device__ float block_scan(float* x, int n, int k, float* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int lo = threadIdx.x * k, hi = min(lo + k, n);
  float own = 0.0f;
  for (int j = lo; j < hi; ++j) own += x[j];
  float incl = own;  // inclusive scan of the threads' totals in the warp
  for (int o = 1; o < 32; o <<= 1) {
    const float up = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl = up + incl;
  }
  float excl = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 31) scratch[warp] = incl;
  __syncthreads();
  float offset = 0.0f;
  for (int w = 0; w < warp; ++w) offset += scratch[w];
  excl = lane == 0 ? offset : offset + excl;
  float acc = excl;
  for (int j = lo; j < hi; ++j) {
    acc = acc + x[j];
    x[j] = acc;
  }
  __syncthreads();
  const float total = x[n - 1];
  __syncthreads();
  return total;
}

__global__ void __launch_bounds__(kMaxThreads)
smc_update_kernel(const float* __restrict__ old_lw, const float* __restrict__ incr,
                  const float* __restrict__ old_evidence, const float* __restrict__ u_ptr,
                  int n, int k, float log_n, float inv_n, float threshold, Fields f,
                  float* __restrict__ out_lw, float* __restrict__ out_evidence,
                  float* __restrict__ out_ess, int64_t* __restrict__ out_idx) {
  extern __shared__ float smem[];
  float* s_w = smem;      // the weights, then the normalized weights
  float* s_cdf = smem + n;  // the resampling weights, then their cdf
  __shared__ float scratch[kWarps];
  const int tid = threadIdx.x, step = blockDim.x;

  // 1. the new weights, their logsumexp, the evidence, the normalized weights
  float m = -INFINITY;
  for (int i = tid; i < n; i += step) {
    const float w = old_lw[i] + incr[i];
    s_w[i] = w;
    m = NanMax()(m, w);
  }
  m = block_reduce(m, NanMax(), scratch);
  const float sh = shift_of(m);
  float s = 0.0f;
  for (int i = tid; i < n; i += step) s += expf(s_w[i] - sh);
  s = block_reduce(s, Add(), scratch);
  const float lse = logf(s) + sh;
  const bool fin = isfinite(lse);
  // log(ESS/N) of the normalized weights and the logsumexp that normalizes
  // them again for resampling, both shifted by their maximum m3 (m2 = 2 m3)
  const float m3 = fin ? m - lse : m;
  const float sh2 = shift_of(2.0f * m3), sh3 = shift_of(m3);
  float s2 = 0.0f, s3 = 0.0f;
  for (int i = tid; i < n; i += step) {
    const float x = fin ? s_w[i] - lse : s_w[i];
    s_w[i] = x;
    s2 += expf(2.0f * x - sh2);
    s3 += expf(x - sh3);
  }
  s2 = block_reduce(s2, Add(), scratch);
  s3 = block_reduce(s3, Add(), scratch);
  const float ess = -(logf(s2) + sh2) - log_n;
  const float lse3 = logf(s3) + sh3;
  const bool fin3 = isfinite(lse3);
  if (tid == 0) {
    *out_evidence = *old_evidence + lse;
    *out_ess = ess;
  }

  // 2. systematic resampling: the cdf, the positions, the indices
  for (int i = tid; i < n; i += step) s_cdf[i] = expf(fin3 ? s_w[i] - lse3 : s_w[i]);
  __syncthreads();
  float total = block_scan(s_cdf, n, k, scratch);
  if (total == 0.0f) {  // every weight is 0: resample uniformly
    for (int i = tid; i < n; i += step) s_cdf[i] = inv_n;
    __syncthreads();
    total = block_scan(s_cdf, n, k, scratch);
  }
  for (int i = tid; i < n; i += step) s_cdf[i] = s_cdf[i] / total;
  __syncthreads();

  // 3. select per particle: the resampled row or its own
  const bool resample = ess < threshold;
  const float u = *u_ptr;
  for (int i = tid; i < n; i += step) {
    const float pos = (u + (float)i) * inv_n;
    int lo = 0, hi = n;
    while (lo < hi) {
      const int mid = lo + ((hi - lo) >> 1);
      if (!(s_cdf[mid] >= pos)) lo = mid + 1;
      else hi = mid;
    }
    const int idx = min(lo, n - 1);
    if (out_idx != nullptr) out_idx[i] = idx;
    const int row = resample ? idx : i;
    out_lw[i] = resample ? -log_n : s_w[i];
    for (int c = 0; c < f.count; ++c) {
      const int w = f.width[c];
      const float* src = f.src[c] + (size_t)row * w;
      float* dst = f.dst[c] + (size_t)i * w;
      for (int j = 0; j < w; ++j) dst[j] = src[j];
    }
  }
}

}  // namespace

// Plain C entry point (bound with ctypes). Launches one block on `stream`,
// allocates nothing, does not synchronise; returns cudaGetLastError() after
// the launch (0 on success), or cudaErrorInvalidValue for a size it does not
// take. Inputs: `old_log_weights` and `incr` [n], `old_evidence` and `u`
// (the resampling uniform) one float each, all device pointers; `log_n` and
// `inv_n` the fp32 roundings of log n and 1 / n, `threshold` of the ESS
// threshold. `src`, `dst`, `widths`: host arrays of `n_fields` device
// pointers to contiguous [n, width] fp32 fields and their widths. Outputs:
// `out_log_weights` [n], `out_evidence`, `out_log_relative_ess`, and, where
// not null, `out_indices` [n] (int64, the systematic draw's indices).
extern "C" int bpe_smc_update(const float* old_log_weights, const float* incr,
                              const float* old_evidence, const float* u, int n, float log_n,
                              float inv_n, float threshold, const float* const* src,
                              float* const* dst, const int* widths, int n_fields,
                              float* out_log_weights, float* out_evidence,
                              float* out_log_relative_ess, int64_t* out_indices,
                              void* stream) {
  if (n < 1 || n > kMaxParticles || n_fields < 0 || n_fields > kMaxFields)
    return (int)cudaErrorInvalidValue;
  Fields f = {};
  for (int c = 0; c < n_fields; ++c) {
    if (widths[c] < 1) return (int)cudaErrorInvalidValue;
    f.src[c] = src[c];
    f.dst[c] = dst[c];
    f.width[c] = widths[c];
  }
  f.count = n_fields;
  const int k = (n + kMaxThreads - 1) / kMaxThreads;  // particles a thread in the scan
  const int threads = ((n + k - 1) / k + 31) / 32 * 32;
  const size_t smem = 2 * sizeof(float) * (size_t)n;
  smc_update_kernel<<<1, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      old_log_weights, incr, old_evidence, u, n, k, log_n, inv_n, threshold, f,
      out_log_weights, out_evidence, out_log_relative_ess, out_indices);
  return (int)cudaGetLastError();
}


// The MH move after the render, in one launch.
//
// Replaces no TPU kernel: the JAX step's tail (the likelihood's regularizer,
// the point prior, tempering, the previous sample re-tempered, the MH test
// and its select, the SMC increment) is plain jnp that XLA fuses. The port
// ran it as 39-49 small kernels a move on an H100 (samplers/mh.py's plain
// version, mh_transition_plain), each over 1-1,000 floats; this kernel takes
// their place. What bounds it is the launch, not bytes (~100 B a particle)
// or operations (~40 a particle).
//
// Per particle i, in fp32, in the plain version's operation order (built
// with -fmad=false, so nothing is contracted where the plain version rounds
// twice):
//   1. the likelihood, logdensity_npixel: where sum_o is 0, -inf; else
//      (1 / sum_o) * c_reg * ell_raw (torch divides a number by a tensor as
//      the tensor's reciprocal times the number);
//   2. the point prior: Normal(prior_t, sigma_t) at t, each coordinate
//      ((z * -0.5) * z - log sigma) - log(2 pi) / 2 with z = (t - mu) / sigma,
//      summed as (x + z) + y (the order of torch's sum over the last axis of
//      three on the card), plus QuaternionUniform's -log |S^3|;
//   3. log_prob = prior + (phi' > 0 ? phi' * like : 0) (tempered_logdensity);
//   4. the previous log_prob re-tempered: + (phi' - phi != 0 ? (phi' - phi) *
//      its like : 0) (retemper);
//   5. alpha = ((log_prob - previous) + q_backward) - q_forward, the two
//      transition terms constant (0 for a symmetric proposal);
//   6. accept where log u <= alpha: t, r, log_prob, log_like from the
//      proposal, else from the previous sample (its re-tempered log_prob);
//   7. where asked, the SMC increment (phi' - phi) * the previous like.
// The temperatures, the prior's mean and sigma are read from device memory
// (a tuned runner's rows), so one capture serves every call.
namespace {

constexpr int kMoveThreads = 128;

__global__ void __launch_bounds__(kMoveThreads)
mh_move_kernel(int n, const float* __restrict__ ell_raw, const float* __restrict__ sum_o,
               const float* __restrict__ prop_t, const float* __restrict__ prop_r,
               const float* __restrict__ prev_t, const float* __restrict__ prev_r,
               const float* __restrict__ prev_log_prob, const float* __restrict__ prev_log_like,
               const float* __restrict__ u, const float* __restrict__ old_temp,
               const float* __restrict__ new_temp, const float* __restrict__ prior_t,
               int prior_t_stride, const float* __restrict__ sigma_t, int sigma_t_stride,
               float c_reg, float half_log_2pi, float log_r_density, float q_backward,
               float q_forward, float* __restrict__ out_t, float* __restrict__ out_r,
               float* __restrict__ out_log_prob, float* __restrict__ out_log_like,
               float* __restrict__ out_incr) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  // 1. the likelihood
  const float so = sum_o[i];
  const float safe = so == 0.0f ? 1.0f : so;
  const float like = so == 0.0f ? -INFINITY : (1.0f / safe) * c_reg * ell_raw[i];
  // 2. the point prior
  float term[3];
  for (int k = 0; k < 3; ++k) {
    const float sigma = sigma_t[k * sigma_t_stride];
    const float z = (prop_t[3 * i + k] - prior_t[k * prior_t_stride]) / sigma;
    term[k] = ((z * -0.5f) * z - logf(sigma)) - half_log_2pi;
  }
  const float prior = ((term[0] + term[2]) + term[1]) + log_r_density;
  // 3. tempered, 4. the previous sample re-tempered
  const float phi = *old_temp, phi_new = *new_temp;
  const float log_prob = prior + (phi_new > 0.0f ? phi_new * like : 0.0f);
  const float delta = phi_new - phi;
  const float prev_like = prev_log_like[i];
  const float prev = prev_log_prob[i] + (delta != 0.0f ? delta * prev_like : 0.0f);
  // 5. the MH test, 6. the select
  const float alpha = ((log_prob - prev) + q_backward) - q_forward;
  const bool accept = logf(u[i]) <= alpha;
  const float* t = accept ? prop_t : prev_t;
  const float* r = accept ? prop_r : prev_r;
  for (int k = 0; k < 3; ++k) out_t[3 * i + k] = t[3 * i + k];
  for (int k = 0; k < 4; ++k) out_r[4 * i + k] = r[4 * i + k];
  out_log_prob[i] = accept ? log_prob : prev;
  out_log_like[i] = accept ? like : prev_like;
  // 7. the SMC increment
  if (out_incr != nullptr) out_incr[i] = delta * prev_like;
}

}  // namespace

// Plain C entry point (bound with ctypes). Launches ceil(n / 128) blocks on
// `stream`, allocates nothing, does not synchronise; returns
// cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for a size it does not take. Inputs, device
// pointers: the render's `ell_raw` and `sum_o` [n], the proposed `prop_t`
// [n, 3] and `prop_r` [n, 4], the previous sample's `prev_t`, `prev_r`,
// `prev_log_prob` and `prev_log_like`, the uniforms `u` [n], the temperatures
// `old_temp` and `new_temp` (one float each), the prior's `prior_t` and
// `sigma_t` (3 floats at a stride of 1, or one at a stride of 0); host
// numbers: `c_reg`, the fp32 roundings of log(2 pi) / 2 and of -log |S^3|,
// and the proposal's two constant transition terms. Outputs [n, 3], [n, 4],
// [n], [n], and, where not null, the increment [n].
extern "C" int bpe_mh_move(int n, const float* ell_raw, const float* sum_o, const float* prop_t,
                           const float* prop_r, const float* prev_t, const float* prev_r,
                           const float* prev_log_prob, const float* prev_log_like,
                           const float* u, const float* old_temp, const float* new_temp,
                           const float* prior_t, int prior_t_stride, const float* sigma_t,
                           int sigma_t_stride, float c_reg, float half_log_2pi,
                           float log_r_density, float q_backward, float q_forward,
                           float* out_t, float* out_r, float* out_log_prob,
                           float* out_log_like, float* out_incr, void* stream) {
  if (n < 1 || prior_t_stride < 0 || prior_t_stride > 1 || sigma_t_stride < 0 ||
      sigma_t_stride > 1)
    return (int)cudaErrorInvalidValue;
  const int blocks = (n + kMoveThreads - 1) / kMoveThreads;
  mh_move_kernel<<<blocks, kMoveThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      n, ell_raw, sum_o, prop_t, prop_r, prev_t, prev_r, prev_log_prob, prev_log_like, u,
      old_temp, new_temp, prior_t, prior_t_stride, sigma_t, sigma_t_stride, c_reg,
      half_log_2pi, log_r_density, q_backward, q_forward, out_t, out_r, out_log_prob,
      out_log_like, out_incr);
  return (int)cudaGetLastError();
}
