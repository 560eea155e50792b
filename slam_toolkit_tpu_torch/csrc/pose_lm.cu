// Motion-only pose Levenberg-Marquardt: the whole solve in one launch of
// one thread-block cluster.
//
// Replaces slam_toolkit_tpu/ops/pose_lm_kernel.py::_pose_lm_pallas (the
// pl.pallas_call at pose_lm_kernel.py:224) and follows it step by step:
// per iteration Huber IRLS weights, 21 + 6 reductions into the 6x6
// normal equations, Levenberg damping, a Jacobi-scaled unpivoted
// Gauss-Jordan solve, SE3 exp and Gram-Schmidt, the trial cost with the
// behind-camera penalty, and accept (cost_try < cost) or reject. Final
// r2 is +inf for masked or behind-camera observations. On the main path
// it solves N = 3072 observations for 10 iterations every frame.
//
// What bounds it on an H100: latency, not bytes or FLOPs. The data is
// N * 7 floats (86 KB at N = 3072) and each iteration is ~230 FLOPs per
// observation; what costs is the chain of dependent steps: a reduction
// over all observations and a serial 6x6 solve per iteration.
//
// Design: one cluster of 8 CTAs of 128 threads; CTA r owns observations
// [r * nc, (r + 1) * nc), nc = ceil(N / 8), and loads them into shared
// memory once (X, z, 1/sigma, weight). One pass a step:
// - Every thread of every CTA holds the pose, the damping, the cost and
//   the normal equations' sums, all equal across the cluster. It solves
//   the damped 6x6 system itself (fully unrolled, in registers) and
//   forms the trial pose: no thread waits on another for the solve.
// - A pass over the CTA's observations at the trial pose gives the trial
//   cost and, speculatively, the 27 normal-equation terms at the trial
//   pose: if the step is accepted they are the next step's normal
//   equations; if it is rejected the pose, and so the normal equations,
//   stay as they were. So each step needs one reduction, not two, and
//   computes what the one-block kernel computed.
// - The 29 terms (30 with the weight sum in the first pass) are reduced
//   by slam::cluster_sum (common.cuh) in a fixed order: a transposing
//   butterfly within each warp (31 shuffles for 32 values), then after
//   one cluster.sync() every CTA reads the 8 ranks x 4 warps partials
//   through distributed shared memory in rank order. Every CTA gets the
//   same sums bit for bit and takes the same accept branch. A step has
//   no other cluster.sync(), so the partials are double-buffered by step
//   parity; the sums by which of them holds the current normal
//   equations.
// A final cluster.sync() keeps every CTA resident until no other can
// still read its shared memory.
#include <cooperative_groups.h>
#include <math.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kCluster = 8;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxPerCta = 1536;       // observations a CTA holds (43 KB)
constexpr int kObsF = 7;               // X (3), z (2), 1/sigma, weight

struct Obs {
  float xc, yc, iz, good, ru, rv;
};

// Observation q of this CTA: field f at o[f * nc + q].
__device__ __forceinline__ Obs residual(const float (&T)[16], const float* o,
                                        int nc, int q) {
  const float X0 = o[q], X1 = o[nc + q], X2 = o[2 * nc + q];
  const float isg = o[5 * nc + q];
  Obs r;
  r.xc = T[0] * X0 + T[1] * X1 + T[2] * X2 + T[3];
  r.yc = T[4] * X0 + T[5] * X1 + T[6] * X2 + T[7];
  const float zc = T[8] * X0 + T[9] * X1 + T[10] * X2 + T[11];
  const bool good = zc > 1e-3f;
  r.good = good ? 1.0f : 0.0f;
  r.iz = 1.0f / (good ? zc : 1.0f);
  r.ru = (r.xc * r.iz - o[3 * nc + q]) * isg;
  r.rv = (r.yc * r.iz - o[4 * nc + q]) * isg;
  return r;
}

// This thread's observations at pose T: v[0..27) the normal-equation
// terms, v[27] the robust cost, v[28] the weight in front of the camera,
// v[29] the weight (the caller uses it once).
__device__ void pass_terms(const float (&T)[16], const float* o, int nc,
                           int np, float delta, float (&v)[32]) {
#pragma unroll
  for (int k = 0; k < 32; ++k) v[k] = 0.0f;
  for (int q = threadIdx.x; q < np; q += kThreads) {
    const float isg = o[5 * nc + q], wv = o[6 * nc + q];
    const Obs r = residual(T, o, nc, q);
    const float w = wv * r.good;
    const float rn = sqrtf(r.ru * r.ru + r.rv * r.rv);
    const float w_rob = w * fminf(1.0f, delta / fmaxf(rn, 1e-12f));
    const float x = r.xc * r.iz, y = r.yc * r.iz;
    const float ju[6] = {r.iz * isg, 0.0f, -x * r.iz * isg,
                         -x * y * isg, (1.0f + x * x) * isg, -y * isg};
    const float jv[6] = {0.0f, r.iz * isg, -y * r.iz * isg,
                         -(1.0f + y * y) * isg, x * y * isg, x * isg};
    int k = 0;
#pragma unroll
    for (int a = 0; a < 6; ++a) {
#pragma unroll
      for (int b = a; b < 6; ++b) {
        v[k++] += w_rob * (ju[a] * ju[b] + jv[a] * jv[b]);
      }
    }
#pragma unroll
    for (int a = 0; a < 6; ++a) v[21 + a] -= w_rob * (ju[a] * r.ru + jv[a] * r.rv);
    const float rho = rn <= delta ? 0.5f * rn * rn : delta * (rn - 0.5f * delta);
    v[27] += rho * w;
    v[28] += w;
    v[29] += wv;
  }
}

// (6x6 damped system from the 21 + 6 sums, rhs) -> the step; Jacobi-scaled,
// no pivoting (pose_lm_kernel.py _solve6), unrolled in registers.
__device__ __forceinline__ void solve_step(const float* s, float lam,
                                           float (&xi)[6]) {
  float H[6][6];
  int k = 0;
#pragma unroll
  for (int a = 0; a < 6; ++a) {
#pragma unroll
    for (int b = a; b < 6; ++b) {
      H[a][b] = s[k];
      H[b][a] = s[k];
      ++k;
    }
  }
#pragma unroll
  for (int a = 0; a < 6; ++a) H[a][a] += lam * H[a][a] + 1e-9f;
  float d[6], M[6][7];
#pragma unroll
  for (int i = 0; i < 6; ++i) d[i] = rsqrtf(fmaxf(H[i][i], 1e-30f));
#pragma unroll
  for (int i = 0; i < 6; ++i) {
#pragma unroll
    for (int j = 0; j < 6; ++j) M[i][j] = H[i][j] * d[i] * d[j];
    M[i][6] = s[21 + i] * d[i];
  }
#pragma unroll
  for (int kk = 0; kk < 6; ++kk) {
    float row[7], col[6];
    const float piv = M[kk][kk];
#pragma unroll
    for (int j = 0; j < 7; ++j) row[j] = M[kk][j] / piv;
#pragma unroll
    for (int i = 0; i < 6; ++i) col[i] = M[i][kk];
#pragma unroll
    for (int i = 0; i < 6; ++i) {
#pragma unroll
      for (int j = 0; j < 7; ++j) {
        M[i][j] = (i == kk) ? row[j] : M[i][j] - col[i] * row[j];
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 6; ++i) xi[i] = M[i][6] * d[i];
}

__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads)
pose_lm_kernel(const float* __restrict__ T_init, const float* __restrict__ X,
               const float* __restrict__ Z, const float* __restrict__ sigma2,
               const float* __restrict__ wv, int n, int iters, float delta,
               float lam0, float lam_up, float lam_down,
               float* __restrict__ T_out, float* __restrict__ cost_out,
               float* __restrict__ r2_out) {
  extern __shared__ float obs[];                // [kObsF][nc]
  __shared__ float part[2][kWarps][32];         // this CTA's partials
  __shared__ float sums[2][32];                 // the cluster's sums

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x;
  const int nc = (n + kCluster - 1) / kCluster;
  const int i0 = rank * nc;
  const int np = max(0, min(nc, n - i0));       // observations of this CTA
  for (int q = tid; q < np; q += kThreads) {
    const int i = i0 + q;
    obs[q] = X[i * 3];
    obs[nc + q] = X[i * 3 + 1];
    obs[2 * nc + q] = X[i * 3 + 2];
    obs[3 * nc + q] = Z[i * 2];
    obs[4 * nc + q] = Z[i * 2 + 1];
    obs[5 * nc + q] = rsqrtf(fmaxf(sigma2[i], 1e-12f));
    obs[6 * nc + q] = wv[i];
  }
  float T[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) T[k] = T_init[k];
  __syncthreads();
  const float behind_pen = delta * (1e3f - 0.5f * delta);

  // every thread of the cluster holds the same pose, damping, cost and
  // normal equations (sums[cur])
  float v[32];
  pass_terms(T, obs, nc, np, delta, v);
  slam::cluster_sum<32, kWarps, kCluster>(cluster, v, 30, part[0], sums[0]);
  int cur = 0;
  const float wv_sum = sums[0][29];
  float cost = sums[0][27] + behind_pen * (sums[0][29] - sums[0][28]);
  float lam = lam0;

  for (int it = 0; it < iters; ++it) {
    float xi[6], T_try[16];
    solve_step(sums[cur], lam, xi);
    slam::se3_left_update(xi, T, T_try);
    pass_terms(T_try, obs, nc, np, delta, v);
    slam::cluster_sum<32, kWarps, kCluster>(cluster, v, 29, part[(it + 1) & 1],
                                            sums[cur ^ 1]);
    const float cost_try = sums[cur ^ 1][27] +
                           behind_pen * (wv_sum - sums[cur ^ 1][28]);
    if (cost_try < cost) {
#pragma unroll
      for (int k = 0; k < 16; ++k) T[k] = T_try[k];
      cost = cost_try;
      cur ^= 1;
      lam *= lam_down;
    } else {
      lam *= lam_up;
    }
  }

  for (int q = tid; q < np; q += kThreads) {
    const Obs r = residual(T, obs, nc, q);
    r2_out[i0 + q] = (obs[6 * nc + q] * r.good > 0.0f) ? r.ru * r.ru + r.rv * r.rv
                                                       : INFINITY;
  }
  if (rank == 0 && tid < 16) T_out[tid] = T[tid];
  if (rank == 0 && tid == 0) cost_out[0] = cost;
  // no CTA leaves while another may still read its shared memory
  cluster.sync();
}

}  // namespace

// The most observations one launch holds.
SLAM_API int slam_pose_lm_max_obs() { return kCluster * kMaxPerCta; }

SLAM_API int slam_pose_lm(const float* T_init, const float* X, const float* Z,
                          const float* sigma2, const float* wv, int n,
                          int iters, float delta, float lam0, float lam_up,
                          float lam_down, float* T_out, float* cost_out,
                          float* r2_out, cudaStream_t stream) {
  if (n < 0 || n > kCluster * kMaxPerCta || iters < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t bytes = sizeof(float) * kObsF * ((n + kCluster - 1) / kCluster);
  pose_lm_kernel<<<kCluster, kThreads, bytes, stream>>>(
      T_init, X, Z, sigma2, wv, n, iters, delta, lam0, lam_up, lam_down,
      T_out, cost_out, r2_out);
  return static_cast<int>(cudaGetLastError());
}
