// Fused transform + rasterize + associate + score for a batch of pose
// hypotheses, written by hand for Hopper (sm_90a).
//
// Replaces: the Pallas TPU kernel `score_kernel` in
//   bayesianposeestimation/jl_tpu/ops/pallas_raster.py:937-966, reached through
//   `pallas_render_score` (:1117, pallas_call at :1196), with every score
//   function of jl_tpu/models/fused.py:53-113, its run-time `hyper` row
//   (`with_hyper`, :938-954; SMEM operand :1189-1194) and its `return_mu`
//   form (`with_mu`, :943-964; output spec :1174-1178); and the depth-only
//   `render_kernel` (:930-935) reached through `pallas_render_depth` (:1056,
//   pallas_call at :1092).
//
// What it computes, per pose n (one thread block each):
//   1. transform the mesh by (t_n, q_n), project with the pinhole camera
//      (z clamped to `near` for the projection), and cull whole triangles:
//      |area| <= 1e-9, any vertex depth outside (near, far), bounding box off
//      the viewport [-0.5, W-0.5] x [-0.5, H-0.5], or area >= 0 (backface)
//      when backface culling is on — the rules of build_forms (:588-714);
//   2. for every pixel centre (integer col, row), the barycentric inside test
//      w0', w1', 1 - w0' - w1' >= -1e-5 against every live triangle, and the
//      max of the perspective-correct inverse depth
//      d = sum_i w_i' / z_i; mu = 1 / max d (0 where nothing covers it);
//   3. the score epilogue, one of five (template parameter, so the raster
//      core is shared unchanged), with z = +inf for invalid pixels:
//        fixed-o            o = prior, ell_px = log pixel_mixture(mu, o)(z)
//                           (variants simple, smooth_simple)
//        association        o = marginalized association (exponential tail)
//                           (association, association_simple_reg)
//        smooth association o and ell_px with the smoothly truncated
//                           exponential tail (smooth, smooth_simple_reg)
//        uniform fixed-o    o = prior, uniform tail (no_exp)
//        uniform association                       (no_exp_association)
//      The likelihood sigmas are scalar arguments, or, when `hyper` is not
//      null, hyper[0] (pixel) and hyper[1] (association) read from device
//      memory, so one kernel serves every hyperparameter candidate;
//   4. ell[n] = sum_px ell_px and sum_o[n] = sum_px o: pixel c of the g-th
//      segment of 16 along a row adds to accumulator [g mod 32][c] of 512,
//      each owned by one thread, and those are added in a fixed order (no
//      floating-point atomic anywhere: repeated runs agree bit for bit, and
//      so do launches that differ in threads per block, face chunks or row
//      bands);
//   5. with the kMu switch, mu itself goes to an [N, H*W] image (0 where
//      nothing covers the pixel). The depth-only kernel (kDepthOnly) does
//      steps 1-2 and this store and nothing else: no observation, no score,
//      no reduction.
//
// Design. A launch at the shapes this package runs is about a million
// (triangle, pixel) tests that matter, a few hundred thousand face set-ups
// and up to a few million score epilogues: small, latency-bound work. So the
// block does each piece once, on the threads that suit it, out of shared
// memory:
//   * set-up, once per pose: every vertex is projected once into shared
//     memory (coalesced reads of `verts`; meshes above 64 KB of projected
//     vertices fall back to projecting each face's corners); then one face
//     per thread builds its edge forms pre-divided by the signed area, three
//     inverse-depth coefficients and its pixel box, and the live faces with
//     a non-empty box are compacted (one warp ballot and one shared-memory
//     atomicAdd per warp) into 13 words each of dynamic shared memory. The
//     forms are built once per launch, not once per image tile;
//   * the box holds every pixel at which the fp32 inside test can pass: the
//     triangle's extent grown by ext * (4e-5 + r) + 1e-6 M, where r bounds
//     the rounding of the weights relative to the area (see triangle_boxes
//     in ops/cuda_raster.py, which this rule mirrors line for line and where
//     it is derived); a sliver whose area is rounding noise (r >= 6) gets the
//     whole image;
//   * raster, triangle-parallel: a group of 4-32 lanes (picked per block:
//     about half its mean box area) takes one live triangle and walks the pixels
//     of its box; a pixel that passes the unchanged inside test puts the bit
//     pattern of its inverse depth into a per-pose image in shared memory
//     with an integer atomicMax (positive floats order as their bits; a max
//     does not depend on order; `d > 0` drops what fmaxf(0, d) dropped).
//     The few boxes above 128 pixels (near triangles, slivers) are set aside
//     and walked by the whole block, so no group is left with a long tail;
//   * epilogue, pixel-parallel over the finished image: mu, the score, the
//     image store straight from the value, the sums as in 4. The score of an
//     uncovered pixel does not depend on the pose, so where the launch is
//     large (the host decides: a million pixel evaluations) a first small
//     kernel takes it once per pixel (score_background_kernel) and the
//     blocks evaluate the epilogue only where a triangle covers;
//   * no size limit: faces that do not fit are taken in chunks and an image
//     that does not fit in tiles (each tile visits only the boxes that meet
//     it; the forms are kept across tiles unless the faces too come in
//     chunks); the host's `launch_plan` (ops/cuda_raster.py) sizes both to
//     the 227 KB a block may take less the static part (kSmemStatic), and
//     can force small ones so that these paths are tested;
//   * threads per block are the host's choice (512 where the poses are fewer
//     than two per SM, else 256), so few poses still spread their set-up.
//   * several pose blocks an SM where the faces take chunks: a block's
//     set-up, barriers and raster are latency chains (dependent IEEE
//     divisions, shared-memory atomics, two barriers a chunk), which one
//     block of 8 warps alone on an SM cannot hide. So where a score launch's
//     poses outnumber the SMs, launch_plan shrinks the face chunk until
//     ceil(N / 132) blocks share an SM (at most 4 of 256 threads, which 64
//     registers a thread allow, with a chunk of half the block's threads or
//     more): at 20,000 faces and 100x100, 252 faces a chunk and 4 blocks an
//     SM in place of 2,194 and 1 (launch_plan's "resident" path). The score
//     kernels take 54-61 registers; chip_smoke.py's phase 2 holds the plan's
//     blocks an SM to the runtime's count (bpe_score_occupancy) for each.
//     The kernel is unchanged: a chunk is a chunk, and the image and the
//     sums do not depend on its size. Below one pose an SM the larger chunk
//     is kept: one block an SM either way, and more chunks cost barriers.
//   * a few poses of a large mesh (the BOP evaluation: 2-5 poses of
//     81,920-128,000 faces at 100x100) would leave most SMs idle and walk
//     dozens of face chunks in turn, so the depth-only kernel splits each
//     pose's faces over face_slices blocks (launch_plan: below 66 poses,
//     about two blocks per SM in all, a few hundred faces or more a slice,
//     one chunk each where it fits). Each block does the unchanged set-up, box rule and
//     raster on its slice, then merges the pixels it covers into the pose's
//     image in device memory (zeroed first) with the same integer atomicMax
//     of the inverse depth's bits; a second small kernel turns the bits into
//     mu with the same expression. A max does not depend on order, so the
//     image is bitwise the one a single block per pose makes. A second
//     kernel (not the last block to arrive) because it needs no arrival
//     counter or scratch and the stream orders it after every merge; it
//     costs one launch gap.
//   * all geometry in fp32, evaluated directly: none of the TPU workarounds
//     (bf16x2 split, 2^30 inside scaling, 8-pose sublane blocks, MXU edge
//     contraction, 256 px side limit, antipodal face pairing).
//   * built with -fmad=false so every product and sum rounds as in the plain
//     PyTorch version (ops/cuda_raster.py: render_score_reference), which
//     evaluates the same expressions in the same order: the inside test, the
//     one decision that can flip a pixel, then agrees with it exactly.
//
// Deliberately not used: the tensor cores (a launch is about a million pair
// tests of 15 fp32 operations; the TPU kernel's MXU edge contraction served
// its all-pixels loop, and its bf16 split cannot give the exact inside test),
// TMA for the mesh (a few KB of vertices per block, L2-resident after the
// first block), thread-block clusters (one block per pose fits a score
// kernel; the depth split takes ~88 slices of a pose at the evaluation
// shape, far above a cluster's 8 blocks, so it merges through L2).
//
// The smooth epilogue reproduces the JAX package's kernel-safe log Phi
// (jl_tpu/distributions.py:56-93): the A&S 7.1.26 erf above x = -4, the
// 3-term asymptotic series below, and its 1e-38 floors as an explicit -inf
// below FLT_MIN (XLA flushes the subnormal floor; without -ftz this build
// would keep it).
//
// The image store and the depth-only form are compile-time switches
// (template parameters), so the score instantiations without an image keep
// their code; every image offset is 64-bit (N*H*W may pass 2^31).
//
// What bounds it on an H100: operations, not bytes, for the score forms (a
// few tens of KB in, 8 bytes per pose out); bytes for the forms that write
// the image (N*H*W*4 out). The measuring script (chip_smoke.py) computes the
// bound from each run's inputs: the fp32 operations of the face set-ups, of
// the pixel centres inside each live triangle's exact box and of the
// epilogues, over 67 TFLOP/s, against the bytes over 3.35 TB/s. Measured on
// an NVIDIA H100 80GB HBM3 at 700 W (chip_profile.py kernels): 0.016 ms at the
// bench shape and 0.051 ms at the tracking shape with 600 poses, 1.7 % and
// 4.2 % of those bounds, 6-7 times the speed of the all-pixels loop this
// design replaced; the depth-only kernel at the BOP evaluation's shape
// (81,920 faces, 3 poses, 100x100) 0.022-0.025 ms split into 88 face slices
// against 0.34-0.58 ms with one block per pose; at the res100 benchmark
// cell's shape (20,000 faces, 100x100, 1,000 poses, association) 0.87 ms
// with 4 blocks an SM against 1.86 ms with one, 4.3 % and 2.0 % of the bound.
//
// What is left on the table. At the tracking shape half of the blocks'
// cycles are the score epilogue (about 300 operations a covered pixel:
// accurate logf, expf, log1pf and IEEE division, FMA contraction off) and a
// third the raster; at the bench shape the 100 blocks are one latency chain
// each (vertices, faces, raster, epilogue in about 13 us) on 100 of 132 SMs;
// at the res100 shape the face set-up takes 53 % of the cycles (about 250
// instructions a face, four IEEE divisions), the raster 38 %, most of it the
// whole-image boxes of 3-4 slivers a pose, walked by the whole block. A
// warp-local form (each warp rasters its own faces' boxes at once, no face
// chunk in shared memory) was measured no faster than smaller chunks.
// Open: tighter boxes for slivers, FMA contraction (needs proof that it
// flips no pixel), an epilogue that shares its logarithms between pixels of
// equal prior, a pose split over a thread-block cluster at few poses, 16-byte
// loads of z and prior.

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>

namespace {

constexpr int kMaxThreads = 512;
constexpr int kMaxDevices = 64;  // devices whose shared-memory limit is kept
constexpr int kFormWords = 13;  // nine forms and the box c0, c1, r0, r1
constexpr int kBigBox = 128;    // boxes above this many pixels: whole block
constexpr int kAccumulators = 32;  // rows of 16 pixel-sum accumulators
// what a block may take of shared memory on sm_90, and the part of it that
// the kernel declares statically (the accumulators and three counters);
// launch_plan sizes the dynamic part to the rest (_SMEM_LIMIT, _SMEM_STATIC)
constexpr int kSmemLimit = 232448;
constexpr int kSmemStatic = 4224;
constexpr unsigned kFullWarp = 0xffffffffu;
constexpr float kTol = 1e-5f;
// the box rule's constants (ops/cuda_raster.py: _BOX_TOL, _BOX_ERR, ...)
constexpr float kBoxTol = 4e-5f;
constexpr float kBoxErr = 3.0517578125e-05f;  // 2^-15
constexpr float kBoxSlack = 1e-6f;
constexpr float kBoxWhole = 6.0f;
constexpr float kHalfLog2Pi = 0.9189385332046727f;

enum Epilogue : int {
  kFixedO = 0,
  kAssociation = 1,
  kSmoothAssociation = 2,
  kUniformFixedO = 3,
  kUniformAssociation = 4,
  kDepthOnly = 5,  // no score: the kernel stops at the rendered depth
};

struct Camera {
  float fx, fy, s, cx_off, cy_off, near, far;
};

// The camera of a launch: the launch arguments, or, where `cam_row` is not
// null, the seven floats of a device row in the same order (ops/cuda_raster.py
// camera_row), read by every thread at the start of its block (one broadcast
// from the cache), as the Pallas kernels read theirs from `cam_ref`.
__device__ __forceinline__ Camera camera_of(const Camera& cam,
                                            const float* __restrict__ cam_row) {
  if (cam_row == nullptr) return cam;
  return Camera{__ldg(cam_row + 0), __ldg(cam_row + 1), __ldg(cam_row + 2),
                __ldg(cam_row + 3), __ldg(cam_row + 4), __ldg(cam_row + 5),
                __ldg(cam_row + 6)};
}

struct ScoreParams {
  float min_depth, max_depth, theta, pixel_sigma, assoc_sigma;
  // logarithms that do not depend on the pixel, taken once per thread before
  // the pixel loop (the same logf of the same value as taking them per pixel)
  float log_theta, log_pixel_sigma, log_assoc_sigma, log_range;
};

// how the block divides its dynamic shared memory and its work; computed by
// launch_plan in ops/cuda_raster.py
struct Plan {
  int cache_verts;  // projected vertices kept in shared memory
  int face_cap;     // faces per chunk
  int band_rows, band_cols;  // the image tile held in shared memory
  int face_slices;  // blocks per pose, each on a contiguous slice of the faces
                    // (the depth-only kernel; 1 for the score kernels)
};

struct Pose {
  float r00, r01, r02, r10, r11, r12, r20, r21, r22, tx, ty, tz;
};

// Built with -DBPE_PHASE_CLOCKS (chip_profile.py does), thread 0 of every
// block adds the clock cycles its block spent in each phase, read at the
// barrier that ends the phase, to g_phase_clocks: the only view inside the
// kernel where no kernel profiler runs. The default build has none of it.
enum Phase : int {
  kPhaseVertices = 0,  // pose, vertex projection, tile zeroing
  kPhaseFaces = 1,     // forms, culls, boxes, compaction
  kPhaseRaster = 2,    // every chunk's, up to the barrier after it
  kPhaseEpilogue = 3,
  kPhases = 4,
};
#ifdef BPE_PHASE_CLOCKS
__device__ unsigned long long g_phase_clocks[kPhases];
#define BPE_PHASE_START long long phase_t0 = clock64();
#define BPE_PHASE_END(i)                                            \
  if (threadIdx.x == 0) {                                           \
    const long long now = clock64();                                \
    atomicAdd(&g_phase_clocks[i], (unsigned long long)(now - phase_t0)); \
    phase_t0 = now;                                                 \
  }
#else
#define BPE_PHASE_START
#define BPE_PHASE_END(i)
#endif

// Same special case as PyTorch's logaddexp: logaddexp(-inf, -inf) = -inf.
__device__ __forceinline__ float log_add_exp(float a, float b) {
  if (isinf(a) && a == b) return a;
  const float m = fmaxf(a, b);
  return m + log1pf(expf(-fabsf(a - b)));
}

__device__ __forceinline__ float normal_logpdf(float x, float loc, float scale,
                                               float log_scale) {
  const float zs = (x - loc) / scale;
  return -0.5f * zs * zs - log_scale - kHalfLog2Pi;
}

// log(max(v, 1e-38)) with the floor flushed to zero, as XLA evaluates it
__device__ __forceinline__ float log_floored(float v) {
  return v < FLT_MIN ? -INFINITY : logf(v);
}

__device__ __forceinline__ float log1mexp(float a) {
  return log_floored(1.0f - expf(a));
}

// Abramowitz & Stegun 7.1.26
__device__ __forceinline__ float erf_approx(float x) {
  const float s = x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : 0.0f);
  const float ax = fabsf(x);
  const float t = 1.0f / (1.0f + 0.3275911f * ax);
  const float poly =
      t * (0.254829592f +
           t * (-0.284496736f +
                t * (1.421413741f + t * (-1.453152027f + t * 1.061405429f))));
  return s * (1.0f - poly * expf(-ax * ax));
}

__device__ __forceinline__ float log_ndtr(float x) {
  if (x > -4.0f) {
    return log_floored(0.5f * (1.0f + erf_approx(x * 0.7071067811865476f)));
  }
  const float inv2 = 1.0f / (x * x);
  return -0.5f * x * x - logf(-x * 2.5066282746310002f) +
         logf(1.0f - inv2 + 3.0f * inv2 * inv2 - 15.0f * inv2 * inv2 * inv2);
}

// SmoothExponential(low = 0, high = mu, theta, sigma).logpdf(z)
__device__ __forceinline__ float smooth_exp_logpdf(float z, float mu, float theta,
                                                   float log_theta, float sigma) {
  const float low = 0.0f;
  const float span = mu - low;
  const bool ok = span > 0.0f;
  const bool finite_z = isfinite(z);
  const float xs = finite_z ? z : 0.0f;
  const float a = (xs - low) / sigma - sigma / theta;
  const float b = (xs - mu) / sigma - sigma / theta;
  const float la = log_ndtr(a);
  const float lb = log_ndtr(b);
  const float diff = fminf(lb - la, 0.0f);
  const float log_window = la + log1mexp(fminf(diff, -1e-12f));
  const float log_z = log1mexp(-(ok ? span : 1.0f) / theta);
  const float r = sigma / theta;
  const float ll = 0.5f * (r * r) - (xs - low) / theta - log_theta - log_z +
                   log_window;
  return (ok && finite_z) ? ll : -INFINITY;
}

// BinaryMixture(a, b, 1, 1) of two component log densities
__device__ __forceinline__ float even_mixture(float lp_a, float lp_b) {
  const float log_norm = logf(1.0f + 1.0f);
  return log_add_exp(0.0f - log_norm + lp_a, 0.0f - log_norm + lp_b);
}

// pixel_tail: BinaryMixture(Exponential(theta), TailUniform(min, max), 1, 1)
__device__ __forceinline__ float tail_logpdf(float x, const ScoreParams& p) {
  const bool valid = x >= 0.0f;
  const float exp_lp =
      valid ? -(valid ? x : 0.0f) / p.theta - p.log_theta : -INFINITY;
  return even_mixture(exp_lp, -p.log_range);
}

// smooth_tail: BinaryMixture(SmoothExponential(0, mu, theta, sigma), TailUniform)
__device__ __forceinline__ float smooth_tail_logpdf(float z, float mu, float sigma,
                                                    const ScoreParams& p) {
  return even_mixture(smooth_exp_logpdf(z, mu, p.theta, p.log_theta, sigma),
                      -p.log_range);
}

// marginalized association: o = prior p_is / (prior p_is + (1-prior) p_not),
// the prior itself where prior is 0 or 1 or mu <= 0
__device__ __forceinline__ float associate(float prior, float mu, float lp_is,
                                           float lp_not) {
  const float l_is = logf(prior) + lp_is;
  const float l_not = logf(fmaxf(1.0f - prior, 1e-38f)) + lp_not;
  const float post = expf(l_is - log_add_exp(l_is, l_not));
  const bool limit = (prior <= 0.0f) || (prior >= 1.0f) || (mu <= 0.0f);
  return limit ? prior : post;
}

// BinaryMixture(Normal(mu, sigma), tail, o, 1 - o) given the tail's log density
__device__ __forceinline__ float weighted_mixture(float o, float lp_normal,
                                                  float lp_tail) {
  const float wa = o;
  const float wb = 1.0f - o;
  const float log_norm = logf(wa + wb);
  return log_add_exp(logf(wa) - log_norm + lp_normal,
                     logf(wb) - log_norm + lp_tail);
}

// the score epilogue: (ell_px, o) for rendered depth mu, observed z, prior
template <int E>
__device__ __forceinline__ void score(float mu, float z, float prior,
                                      const ScoreParams& p, float* ell,
                                      float* o) {
  const float lp_pixel =
      normal_logpdf(z, mu, p.pixel_sigma, p.log_pixel_sigma);
  if constexpr (E == kFixedO || E == kAssociation) {
    const float tail = tail_logpdf(z, p);
    float oo = prior;
    if constexpr (E == kAssociation) {
      oo = associate(prior, mu, normal_logpdf(z, mu, p.assoc_sigma, p.log_assoc_sigma), tail);
    }
    *ell = weighted_mixture(oo, lp_pixel, tail);
    *o = oo;
  } else if constexpr (E == kSmoothAssociation) {
    const float oo = associate(prior, mu, normal_logpdf(z, mu, p.assoc_sigma, p.log_assoc_sigma),
                               smooth_tail_logpdf(z, mu, p.assoc_sigma, p));
    *ell = weighted_mixture(oo, lp_pixel,
                            smooth_tail_logpdf(z, mu, p.pixel_sigma, p));
    *o = oo;
  } else {  // uniform tail: kUniformFixedO, kUniformAssociation
    const float unif = -p.log_range;
    float oo = prior;
    if constexpr (E == kUniformAssociation) {
      oo = associate(prior, mu, normal_logpdf(z, mu, p.assoc_sigma, p.log_assoc_sigma), unif);
    }
    *ell = weighted_mixture(oo, lp_pixel, unif);
    *o = oo;
  }
}

// the likelihood sigmas from the device row, where there is one, and the
// logarithms that do not depend on the pixel
__device__ __forceinline__ void finish_params(ScoreParams* sp,
                                              const float* __restrict__ hyper) {
  if (hyper != nullptr) {
    sp->pixel_sigma = hyper[0];
    sp->assoc_sigma = hyper[1];
  }
  sp->log_theta = logf(sp->theta);
  sp->log_pixel_sigma = logf(sp->pixel_sigma);
  sp->log_assoc_sigma = logf(sp->assoc_sigma);
  sp->log_range = logf(sp->max_depth - sp->min_depth);
}

// The score of a pixel that no triangle covers (mu = 0) depends on the
// observation and the prior alone, not on the pose: it is taken once per
// launch, here, into background[0 .. n_pix) (ell_px) and [n_pix .. 2 n_pix)
// (o), and the poses' blocks read it for their uncovered pixels. Same
// function on the same values as in the blocks, so nothing changes bitwise.
// `mu_none` is 0, passed at run time so that the epilogue is compiled as
// in the blocks and not specialised.
template <int E>
__global__ void __launch_bounds__(256)
score_background_kernel(const float* __restrict__ z_img,
                        const float* __restrict__ prior_img, size_t n_pix,
                        ScoreParams sp, const float* __restrict__ hyper,
                        float mu_none, float* __restrict__ background) {
  finish_params(&sp, hyper);
  const size_t stride = (size_t)gridDim.x * blockDim.x;
  for (size_t p = (size_t)blockIdx.x * blockDim.x + threadIdx.x; p < n_pix;
       p += stride) {
    float ell_px, o;
    score<E>(mu_none, z_img[p], prior_img[p], sp, &ell_px, &o);
    background[p] = ell_px;
    background[n_pix + p] = o;
  }
}

// camera-frame depth and grid-centred pixel coordinates of one vertex
__device__ __forceinline__ void project(const Pose& p, const Camera& cam,
                                        const float* __restrict__ verts, int vi,
                                        float* u, float* v, float* zc) {
  const float vx = verts[3 * vi + 0];
  const float vy = verts[3 * vi + 1];
  const float vz = verts[3 * vi + 2];
  const float x = p.r00 * vx + p.r01 * vy + p.r02 * vz + p.tx;
  const float y = p.r10 * vx + p.r11 * vy + p.r12 * vz + p.ty;
  const float zz = p.r20 * vx + p.r21 * vy + p.r22 * vz + p.tz;
  const float inv = 1.0f / (zz > cam.near ? zz : cam.near);
  *u = (cam.fx * x + cam.s * y) * inv + cam.cx_off;
  *v = cam.fy * y * inv + cam.cy_off;
  *zc = zz;
}

// first and last pixel index of [lo, hi] along an axis of `size` pixels
__device__ __forceinline__ void box_bounds(float lo, float hi, bool whole,
                                           int size, int* first, int* last) {
  *first = whole ? 0 : (int)fminf(fmaxf(ceilf(lo), 0.0f), (float)size);
  *last = whole ? size - 1
                : (int)fminf(fmaxf(floorf(hi), -1.0f), (float)(size - 1));
}

template <int E, bool kMu>
__global__ void __launch_bounds__(kMaxThreads)
render_score_kernel(const float* __restrict__ verts, int n_verts,
                    const int* __restrict__ faces, int n_faces,
                    const float* __restrict__ t, const float* __restrict__ q,
                    const float* __restrict__ z_img,
                    const float* __restrict__ prior_img, int height, int width,
                    Camera cam_arg, const float* __restrict__ cam_row,
                    int backface_cull, ScoreParams sp,
                    const float* __restrict__ hyper,
                    const float* __restrict__ background, Plan plan,
                    float* __restrict__ ell_out, float* __restrict__ sumo_out,
                    float* __restrict__ mu_out) {
  static_assert(E != kDepthOnly || kMu, "the depth-only kernel writes the image");
  extern __shared__ float s_dyn[];
  __shared__ int s_small, s_big, s_area;
  __shared__ float s_acc[2][kAccumulators][16];
  static_assert(sizeof(s_acc) + 3 * sizeof(int) <= kSmemStatic,
                "kSmemStatic must cover the static shared memory");

  BPE_PHASE_START
  const Camera cam = camera_of(cam_arg, cam_row);
  // The depth-only kernel may split a pose's faces over face_slices blocks
  // (block = pose * face_slices + slice, each on a contiguous slice of the
  // faces); each block rasters its slice into its own tile and then merges
  // the pixels it covers into the pose's image in device memory by an
  // integer atomicMax of the inverse depth's bits (order-free, so the image
  // is the one a single block makes), and depth_resolve_kernel turns the
  // merged bits into mu. The score kernels take one block per pose.
  const int n_slices = E == kDepthOnly ? plan.face_slices : 1;
  const int pose = blockIdx.x / n_slices;
  const int slice = blockIdx.x - pose * n_slices;
  const int per_slice = (n_faces + n_slices - 1) / n_slices;
  const int f_first = min(slice * per_slice, n_faces);
  const int f_last = min(f_first + per_slice, n_faces);  // exclusive
  const bool merge = n_slices > 1;
  if (merge && f_first == f_last) return;  // an empty slice adds nothing
  const int tid = threadIdx.x;
  const int n_threads = blockDim.x;
  const int lane = tid & 31;
  const int cap = plan.face_cap;
  const int n_cached = plan.cache_verts ? n_verts : 0;
  float* s_vu = s_dyn;  // projected vertices: u, v, z [n_cached] each
  float* s_vv = s_vu + n_cached;
  float* s_vz = s_vv + n_cached;
  float* s_form = s_vz + n_cached;                        // [9][cap]
  int* s_box = reinterpret_cast<int*>(s_form + 9 * cap);  // [4][cap]
  int* s_img = s_box + 4 * cap;  // inverse-depth bits [band_rows * band_cols]

  Pose ps;
  {
    const float qw = q[4 * pose + 0], qx = q[4 * pose + 1];
    const float qy = q[4 * pose + 2], qz = q[4 * pose + 3];
    ps.r00 = 1.0f - 2.0f * (qy * qy + qz * qz);
    ps.r01 = 2.0f * (qx * qy - qw * qz);
    ps.r02 = 2.0f * (qx * qz + qw * qy);
    ps.r10 = 2.0f * (qx * qy + qw * qz);
    ps.r11 = 1.0f - 2.0f * (qx * qx + qz * qz);
    ps.r12 = 2.0f * (qy * qz - qw * qx);
    ps.r20 = 2.0f * (qx * qz - qw * qy);
    ps.r21 = 2.0f * (qy * qz + qw * qx);
    ps.r22 = 1.0f - 2.0f * (qx * qx + qy * qy);
    ps.tx = t[3 * pose + 0];
    ps.ty = t[3 * pose + 1];
    ps.tz = t[3 * pose + 2];
  }

  // grid-centred coordinates: pixel centres and the viewport are exact
  // half-integers; the principal point is folded into cx_off / cy_off
  const float gcx = 0.5f * (float)(width - 1);
  const float gcy = 0.5f * (float)(height - 1);
  const float lo_u = -gcx - 0.5f, hi_u = (float)(width - 1) - gcx + 0.5f;
  const float lo_v = -gcy - 0.5f, hi_v = (float)(height - 1) - gcy + 0.5f;
  const size_t n_pix = (size_t)height * (size_t)width;

  if constexpr (E != kDepthOnly) finish_params(&sp, hyper);

  // set-up, part 1: each vertex is projected once (visible after the
  // barrier that precedes the first face build)
  for (int i = tid; i < n_cached; i += n_threads) {
    project(ps, cam, verts, i, &s_vu[i], &s_vv[i], &s_vz[i]);
  }

  // the pixel sums: 32 x 16 accumulators; pixel c of segment g (16 pixels
  // along a row, numbered through the tiles in order) adds to accumulator
  // [g mod 32][c], so the order of additions depends on the image alone, not
  // on the threads, the face chunks or the row bands. Half-warp h takes the
  // segments g = h (mod n_halves): each accumulator has one owner thread.
  const int half = tid >> 4, sub = tid & 15, n_halves = n_threads >> 4;
  int seg_base = 0;
  for (int j = half; j < kAccumulators; j += n_halves) {
    s_acc[0][j][sub] = 0.0f;
    s_acc[1][j][sub] = 0.0f;
  }

  const bool one_chunk = f_last - f_first <= cap;
  bool forms_ready = false;  // with one chunk the forms outlive the tiles

  for (int row0 = 0; row0 < height; row0 += plan.band_rows) {
    for (int col0 = 0; col0 < width; col0 += plan.band_cols) {
      const int bh = min(plan.band_rows, height - row0);
      const int bw = min(plan.band_cols, width - col0);
      const int band_pix = bh * bw;
      for (int i = tid; i < band_pix; i += n_threads) s_img[i] = 0;

      for (int f0 = f_first; f0 < f_last; f0 += cap) {
        if (!forms_ready) {
          // set-up, part 2: forms, culls and box of each face of the chunk
          __syncthreads();  // vertices projected; the chunk before is done
          // a tile's first chunk follows the vertices or the tile's zeroing,
          // a later one the chunk before's raster
          BPE_PHASE_END(f0 == f_first ? kPhaseVertices : kPhaseRaster)
          if (tid == 0) {
            s_small = 0;
            s_big = 0;
            s_area = 0;
          }
          __syncthreads();
          const int f_end = min(f0 + cap, f_last);
          for (int fb = f0; fb < f_end; fb += n_threads) {
            const int f = fb + tid;
            bool valid = false;
            float form[9];
            int c0 = 0, c1 = -1, r0 = 0, r1 = -1, n_box = 0;
            if (f < f_end) {
              float u[3], v[3], zc[3];
              bool idx_ok = true;
#pragma unroll
              for (int j = 0; j < 3; ++j) {
                const int vi = faces[3 * f + j];
                const bool in_range = vi >= 0 && vi < n_verts;
                idx_ok = idx_ok && in_range;
                const int vs = in_range ? vi : 0;
                if (plan.cache_verts) {
                  u[j] = s_vu[vs];
                  v[j] = s_vv[vs];
                  zc[j] = s_vz[vs];
                } else {
                  project(ps, cam, verts, vs, &u[j], &v[j], &zc[j]);
                }
              }
              // edge function opposite vertex i: alpha u + beta v + gamma
              const float a0 = -(v[2] - v[1]), b0 = u[2] - u[1];
              const float c0f = (v[2] - v[1]) * u[1] - (u[2] - u[1]) * v[1];
              const float a1 = -(v[0] - v[2]), b1 = u[0] - u[2];
              const float c1f = (v[0] - v[2]) * u[2] - (u[0] - u[2]) * v[2];
              const float a2 = -(v[1] - v[0]), b2 = u[1] - u[0];
              const float c2f = (v[1] - v[0]) * u[0] - (u[1] - u[0]) * v[0];
              const float area = a2 * u[2] + b2 * v[2] + c2f;
              const float umin = fminf(fminf(u[0], u[1]), u[2]);
              const float umax = fmaxf(fmaxf(u[0], u[1]), u[2]);
              const float vmin = fminf(fminf(v[0], v[1]), v[2]);
              const float vmax = fmaxf(fmaxf(v[0], v[1]), v[2]);
              const bool in_view =
                  umin <= hi_u && umax >= lo_u && vmin <= hi_v && vmax >= lo_v;
              const bool z_ok = zc[0] > cam.near && zc[0] < cam.far &&
                                zc[1] > cam.near && zc[1] < cam.far &&
                                zc[2] > cam.near && zc[2] < cam.far;
              valid = idx_ok && fabsf(area) > 1e-9f && z_ok && in_view;
              if (backface_cull) valid = valid && area < 0.0f;
              if (valid) {
                const float factor = 1.0f / area;
                const float iz0 = 1.0f / zc[0];
                const float iz1 = 1.0f / zc[1];
                const float iz2 = 1.0f / zc[2];
                form[0] = a0 * factor;
                form[1] = b0 * factor;
                form[2] = c0f * factor;
                form[3] = a1 * factor;
                form[4] = b1 * factor;
                form[5] = c1f * factor;
                form[6] = iz2;
                form[7] = iz0 - iz2;
                form[8] = iz1 - iz2;
                // the pixel box (triangle_boxes in ops/cuda_raster.py)
                const float ext_u = umax - umin, ext_v = vmax - vmin;
                const float big_l = fmaxf(ext_u, ext_v);
                float big_m = fmaxf(fmaxf(fabsf(umin), fabsf(umax)),
                                    fmaxf(fabsf(vmin), fabsf(vmax)));
                big_m = fmaxf(big_m, fmaxf(gcx, gcy) + 0.5f);
                const float r = kBoxErr * big_l * big_m / fabsf(area);
                const bool whole = !(r < kBoxWhole) || !(big_l * big_m < 1e30f);
                const float m_u = ext_u * (kBoxTol + r) + kBoxSlack * big_m;
                const float m_v = ext_v * (kBoxTol + r) + kBoxSlack * big_m;
                box_bounds((umin - m_u) + gcx, (umax + m_u) + gcx, whole, width,
                           &c0, &c1);
                box_bounds((vmin - m_v) + gcy, (vmax + m_v) + gcy, whole, height,
                           &r0, &r1);
                n_box = max(c1 - c0 + 1, 0) * max(r1 - r0 + 1, 0);
                valid = n_box > 0;
              }
            }
            // compaction: small boxes from the front, big ones from the back
            const bool big = valid && n_box > kBigBox;
            const bool small = valid && !big;
            const unsigned m_small = __ballot_sync(kFullWarp, small);
            const unsigned m_big = __ballot_sync(kFullWarp, big);
            const int area_sum = __reduce_add_sync(kFullWarp, small ? n_box : 0);
            int base_small = 0, base_big = 0;
            if (lane == 0) {
              if (m_small != 0u) {
                base_small = atomicAdd(&s_small, __popc(m_small));
                atomicAdd(&s_area, area_sum);
              }
              if (m_big != 0u) base_big = atomicAdd(&s_big, __popc(m_big));
            }
            base_small = __shfl_sync(kFullWarp, base_small, 0);
            base_big = __shfl_sync(kFullWarp, base_big, 0);
            if (valid) {
              const unsigned below = (1u << lane) - 1u;
              const int slot = big ? cap - 1 - (base_big + __popc(m_big & below))
                                   : base_small + __popc(m_small & below);
#pragma unroll
              for (int j = 0; j < 9; ++j) s_form[j * cap + slot] = form[j];
              s_box[0 * cap + slot] = c0;
              s_box[1 * cap + slot] = c1;
              s_box[2 * cap + slot] = r0;
              s_box[3 * cap + slot] = r1;
            }
          }
          forms_ready = one_chunk;
        }
        __syncthreads();  // forms, counts and the zeroed tile are visible
        BPE_PHASE_END(kPhaseFaces)

        // raster: lanes `first, first + step, ...` walk the pixels of live
        // triangle k's box inside this tile
        auto raster = [&](int k, int first, int step) {
          const int c0 = max(s_box[0 * cap + k], col0);
          const int c1 = min(s_box[1 * cap + k], col0 + bw - 1);
          const int r0 = max(s_box[2 * cap + k], row0);
          const int r1 = min(s_box[3 * cap + k], row0 + bh - 1);
          if (c0 > c1 || r0 > r1) return;
          const int w = c1 - c0 + 1;
          const int n = w * (r1 - r0 + 1);
          if (first >= n) return;
          // i / w by a product: exact below 2^22 pixels, and a tile holds
          // fewer than 2^16
          const float inv_w = 1.0f / (float)w;
          const float A0 = s_form[0 * cap + k], B0 = s_form[1 * cap + k];
          const float C0 = s_form[2 * cap + k], A1 = s_form[3 * cap + k];
          const float B1 = s_form[4 * cap + k], C1 = s_form[5 * cap + k];
          const float IZ2 = s_form[6 * cap + k], DZ0 = s_form[7 * cap + k];
          const float DZ1 = s_form[8 * cap + k];
          for (int i = first; i < n; i += step) {
            const int rr = __float2int_rz(((float)i + 0.5f) * inv_w);
            const int col = c0 + (i - rr * w), row = r0 + rr;
            const float pu = (float)col - gcx;
            const float pv = (float)row - gcy;
            const float w0 = A0 * pu + B0 * pv + C0;
            const float w1 = A1 * pu + B1 * pv + C1;
            const float w2 = 1.0f - w0 - w1;
            if (w0 >= -kTol && w1 >= -kTol && w2 >= -kTol) {
              const float d = IZ2 + DZ0 * w0 + DZ1 * w1;
              if (d > 0.0f) {
                atomicMax(&s_img[(row - row0) * bw + (col - col0)],
                          __float_as_int(d));
              }
            }
          }
        };
        const int n_small = s_small, n_big = s_big;
        // lanes per triangle, about half the mean box: measured best at 4
        // lanes for boxes of 3-4 pixels and at 8 for boxes of 13-20
        const int mean = s_area / max(n_small, 1);
        int lanes = 4;
        while (lanes < 32 && 2 * lanes < mean) lanes <<= 1;
        const int n_groups = n_threads / lanes;
        for (int k = tid / lanes; k < n_small; k += n_groups) {
          raster(k, tid & (lanes - 1), lanes);
        }
        for (int k = cap - n_big; k < cap; ++k) raster(k, tid, n_threads);
      }
      __syncthreads();  // the tile is complete
      BPE_PHASE_END(kPhaseRaster)

      // epilogue over the tile's pixels, by segments of 16 along a row
      const int seg_per_row = (bw + 15) >> 4;
      const int n_seg = bh * seg_per_row;
      const int first_seg = (half - seg_base % n_halves + n_halves) % n_halves;
      for (int ls = first_seg; ls < n_seg; ls += n_halves) {
        const int lr = ls / seg_per_row;
        const int lc = ((ls - lr * seg_per_row) << 4) + sub;
        if (lc < bw) {
          const size_t p =
              (size_t)(row0 + lr) * (size_t)width + (size_t)(col0 + lc);
          if (merge) {  // the slice's covered pixels into the pose's image
            const int bits = s_img[lr * bw + lc];
            if (bits != 0) {
              atomicMax(reinterpret_cast<int*>(mu_out) + (size_t)pose * n_pix + p,
                        bits);
            }
            continue;
          }
          const float maxd = __int_as_float(s_img[lr * bw + lc]);
          const float mu = maxd > 0.0f ? 1.0f / maxd : 0.0f;
          if constexpr (kMu) {
            mu_out[(size_t)pose * n_pix + p] = mu;
          }
          if constexpr (E != kDepthOnly) {
            float ell_px, o;
            if (background == nullptr || mu > 0.0f) {
              score<E>(mu, z_img[p], prior_img[p], sp, &ell_px, &o);
            } else {  // uncovered: the launch's background score
              ell_px = background[p];
              o = background[n_pix + p];
            }
            const int j = (seg_base + ls) & (kAccumulators - 1);
            s_acc[0][j][sub] += ell_px;
            s_acc[1][j][sub] += o;
          }
        }
      }
      seg_base += n_seg;
      __syncthreads();  // the next tile zeroes the image
      BPE_PHASE_END(kPhaseEpilogue)
    }
  }

  if constexpr (E != kDepthOnly) {
    // the accumulators in a fixed order: lane j of the first warp adds row
    // j's 16 in turn, then a shuffle tree over the lanes (the last barrier
    // above made them visible)
    if (tid < 32) {
      float e = 0.0f, o = 0.0f;
#pragma unroll
      for (int c = 0; c < 16; ++c) {
        e += s_acc[0][lane][c];
        o += s_acc[1][lane][c];
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        e += __shfl_down_sync(kFullWarp, e, off);
        o += __shfl_down_sync(kFullWarp, o, off);
      }
      if (lane == 0) {
        ell_out[pose] = e;
        sumo_out[pose] = o;
      }
    }
  }
}

// The last pass of a split depth launch: the merged inverse-depth bits (0
// where no slice covered the pixel) to mu, in place, by the expression a
// block uses when it holds the whole pose.
__global__ void __launch_bounds__(256)
depth_resolve_kernel(float* __restrict__ mu, size_t n) {
  const size_t stride = (size_t)gridDim.x * blockDim.x;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const float maxd = mu[i];
    mu[i] = maxd > 0.0f ? 1.0f / maxd : 0.0f;
  }
}

bool plan_ok(int threads, const Plan& plan) {
  return threads >= 32 && kMaxThreads % threads == 0 &&
         plan.face_cap >= 1 && plan.band_rows >= 1 && plan.band_cols >= 1 &&
         plan.face_slices >= 1;
}

template <int E, bool kMu>
cudaError_t launch(const float* verts, int n_verts, const int* faces,
                   int n_faces, const float* t, const float* q, int n_poses,
                   const float* z_img, const float* prior_img, int height,
                   int width, const Camera& cam, const float* cam_row,
                   int backface_cull,
                   const ScoreParams& sp, const float* hyper, int threads,
                   const Plan& plan, float* ell, float* sum_o, float* mu,
                   float* background, cudaStream_t stream) {
  if (!plan_ok(threads, plan)) return cudaErrorInvalidValue;
  const int slices = plan.face_slices;
  if (E != kDepthOnly && slices != 1) return cudaErrorInvalidValue;
  if ((long long)n_poses * slices > 0x7fffffffLL) return cudaErrorInvalidValue;
  const size_t n_out = (size_t)n_poses * (size_t)height * (size_t)width;
  if constexpr (E != kDepthOnly) {
    if (background != nullptr) {
      const size_t n_pix = (size_t)height * (size_t)width;
      const size_t blocks = (n_pix + 255) / 256;
      const int grid = (int)(blocks < 1024 ? blocks : 1024);
      score_background_kernel<E><<<grid, 256, 0, stream>>>(
          z_img, prior_img, n_pix, sp, hyper, 0.0f, background);
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return err;
    }
  }
  const size_t words = (plan.cache_verts ? 3 * (size_t)n_verts : 0) +
                       (size_t)kFormWords * plan.face_cap +
                       (size_t)plan.band_rows * plan.band_cols;
  const size_t smem = sizeof(float) * words;
  if (smem + kSmemStatic > kSmemLimit) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {  // above the default limit of dynamic shared memory
    // raised once per device to the largest size asked, so that a launch
    // captured into a CUDA graph after a first eager launch of its plan
    // calls no attribute function
    static int raised[kMaxDevices] = {};
    int device = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err != cudaSuccess) return err;
    if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
    if ((int)smem > raised[device]) {
      err = cudaFuncSetAttribute(render_score_kernel<E, kMu>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)smem);
      if (err != cudaSuccess) return err;
      raised[device] = (int)smem;
    }
  }
  if (slices > 1) {  // the slices merge into a zeroed image
    const cudaError_t err =
        cudaMemsetAsync(mu, 0, sizeof(float) * n_out, stream);
    if (err != cudaSuccess) return err;
  }
  render_score_kernel<E, kMu><<<n_poses * slices, threads, smem, stream>>>(
      verts, n_verts, faces, n_faces, t, q, z_img, prior_img, height, width,
      cam, cam_row, backface_cull, sp, hyper, background, plan, ell, sum_o, mu);
  if (slices == 1) return cudaGetLastError();
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t blocks = (n_out + 255) / 256;
  depth_resolve_kernel<<<(int)(blocks < 4096 ? blocks : 4096), 256, 0, stream>>>(
      mu, n_out);
  return cudaGetLastError();
}

// Blocks of the score kernel for epilogue E (kMu: the form that writes the
// image) that one SM holds at once with `threads` threads and `smem` bytes of
// dynamic shared memory, as the CUDA runtime counts them. The kernel's limit
// of dynamic shared memory is raised to `smem` where it is lower, never
// lowered.
template <int E, bool kMu>
cudaError_t occupancy(int threads, size_t smem, int* blocks) {
  if (smem + kSmemStatic > kSmemLimit) return cudaErrorInvalidValue;
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, render_score_kernel<E, kMu>);
  if (err != cudaSuccess) return err;
  if ((int)smem > attr.maxDynamicSharedSizeBytes) {
    err = cudaFuncSetAttribute(render_score_kernel<E, kMu>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
  }
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, render_score_kernel<E, kMu>, threads, smem);
}

}  // namespace

// Plain C entry point (bound with ctypes). Launches on `stream`, allocates
// nothing, does not synchronise; returns cudaGetLastError() after the launch
// (0 on success), or cudaErrorInvalidValue for an epilogue or a plan it does
// not have. `cam_row`: null, or a device pointer to the seven camera floats
// (fx, fy, s, cx_off, cy_off, near, far), read in place of those arguments.
// `hyper`: null, or a device pointer to [pixel_sigma, association_sigma]. `mu`: null, or a device pointer to an [n_poses,
// height * width] image that receives the rendered depth (0 = background).
// `background`: null, or device scratch of 2 * height * width floats (the
// score of uncovered pixels, written by a first small kernel and read by the
// poses' blocks in place of evaluating the epilogue there). `threads` per
// block and the plan (`cache_verts` ... `band_cols`, see struct Plan) come from
// launch_plan in ops/cuda_raster.py.
extern "C" int bpe_render_score(
    const float* verts, int n_verts, const int* faces, int n_faces,
    const float* t, const float* q, int n_poses, const float* z_img,
    const float* prior_img, int height, int width, float fx, float fy, float s,
    float cx_off, float cy_off, float near, float far, const float* cam_row,
    int backface_cull, int epilogue, float min_depth, float max_depth, float pixel_theta,
    float pixel_sigma, float association_sigma, const float* hyper, float* ell,
    float* sum_o, float* mu, float* background, int threads, int cache_verts,
    int face_cap, int band_rows, int band_cols, void* stream) {
  if (n_poses <= 0) return 0;
  const Camera cam{fx, fy, s, cx_off, cy_off, near, far};
  const ScoreParams sp{min_depth, max_depth, pixel_theta, pixel_sigma,
                       association_sigma};
  const Plan plan{cache_verts, face_cap, band_rows, band_cols, 1};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define BPE_ARGS                                                            \
  verts, n_verts, faces, n_faces, t, q, n_poses, z_img, prior_img, height, \
      width, cam, cam_row, backface_cull, sp, hyper, threads, plan, ell,     \
      sum_o, mu, background, st
#define BPE_LAUNCH(E) \
  (int)(mu != nullptr ? launch<E, true>(BPE_ARGS) : launch<E, false>(BPE_ARGS))
  switch (epilogue) {
    case kFixedO: return BPE_LAUNCH(kFixedO);
    case kAssociation: return BPE_LAUNCH(kAssociation);
    case kSmoothAssociation: return BPE_LAUNCH(kSmoothAssociation);
    case kUniformFixedO: return BPE_LAUNCH(kUniformFixedO);
    case kUniformAssociation: return BPE_LAUNCH(kUniformAssociation);
    default: return (int)cudaErrorInvalidValue;
  }
#undef BPE_LAUNCH
#undef BPE_ARGS
}

// Depth render alone: mu [n_poses, height * width] (0 = background) for the
// same mesh, camera and pose arguments. Same launch rules as above, and
// `face_slices` blocks per pose (launch_plan's rule): with more than one, the
// image is zeroed, the slices merge into it and a second small kernel
// (depth_resolve_kernel) turns it into mu, all on `stream`.
extern "C" int bpe_render_depth(
    const float* verts, int n_verts, const int* faces, int n_faces,
    const float* t, const float* q, int n_poses, int height, int width,
    float fx, float fy, float s, float cx_off, float cy_off, float near,
    float far, const float* cam_row, int backface_cull, float* mu, int threads, int cache_verts,
    int face_cap, int band_rows, int band_cols, int face_slices, void* stream) {
  if (n_poses <= 0) return 0;
  if (mu == nullptr) return (int)cudaErrorInvalidValue;
  const Camera cam{fx, fy, s, cx_off, cy_off, near, far};
  const ScoreParams sp{0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  const Plan plan{cache_verts, face_cap, band_rows, band_cols, face_slices};
  return (int)launch<kDepthOnly, true>(
      verts, n_verts, faces, n_faces, t, q, n_poses, nullptr, nullptr, height,
      width, cam, cam_row, backface_cull, sp, nullptr, threads, plan, nullptr,
      nullptr, mu, nullptr, static_cast<cudaStream_t>(stream));
}

// Blocks of `threads` threads and `smem_bytes` of dynamic shared memory that
// one SM holds at once of the score kernel for `epilogue` (with the image
// where `with_mu` is not 0), as the CUDA runtime counts them
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), into `blocks`: what
// launch_plan's blocks_per_sm is held to on the card.
extern "C" int bpe_score_occupancy(int epilogue, int with_mu, int threads, int smem_bytes,
                                   int* blocks) {
  const size_t smem = (size_t)smem_bytes;
#define BPE_OCCUPANCY(E)                                         \
  (int)(with_mu ? occupancy<E, true>(threads, smem, blocks) \
                : occupancy<E, false>(threads, smem, blocks))
  switch (epilogue) {
    case kFixedO: return BPE_OCCUPANCY(kFixedO);
    case kAssociation: return BPE_OCCUPANCY(kAssociation);
    case kSmoothAssociation: return BPE_OCCUPANCY(kSmoothAssociation);
    case kUniformFixedO: return BPE_OCCUPANCY(kUniformFixedO);
    case kUniformAssociation: return BPE_OCCUPANCY(kUniformAssociation);
    default: return (int)cudaErrorInvalidValue;
  }
#undef BPE_OCCUPANCY
}

#ifdef BPE_PHASE_CLOCKS
// Copies the phase clocks to `out` [4] on the host (synchronises the device),
// then zeroes them when `reset` is not 0.
extern "C" int bpe_phase_clocks(unsigned long long* out, int reset) {
  cudaError_t err = cudaMemcpyFromSymbol(out, g_phase_clocks,
                                         sizeof(unsigned long long) * kPhases);
  if (err == cudaSuccess && reset != 0) {
    const unsigned long long zero[kPhases] = {0, 0, 0, 0};
    err = cudaMemcpyToSymbol(g_phase_clocks, zero, sizeof(zero));
  }
  return (int)err;
}
#endif
