// Shared declarations of the kernel library (see utils/cuda_lib.py).
//
// Every entry point has C linkage, takes the CUDA stream last, launches
// on it without synchronising, and returns cudaGetLastError() so the
// Python wrapper can raise on a launch the CUDA runtime refused.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define SLAM_API extern "C" __attribute__((visibility("default")))

namespace slam {

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// One stage of a transposing butterfly over v[0..32) of a warp: each lane
// keeps the half of the values its bit O selects and adds the partner's.
template <int O>
__device__ __forceinline__ void fold(float (&v)[32], bool up) {
#pragma unroll
  for (int k = 0; k < O; ++k) {
    const float send = up ? v[k] : v[k + O];
    const float keep = up ? v[k + O] : v[k];
    v[k] = keep + __shfl_xor_sync(0xFFFFFFFFu, send, O);
  }
}

// Sums v[0..NV) of every thread of a cluster of kCluster CTAs of kWarps
// warps into out[0..nv) (shared) of every CTA, in a fixed order: within a
// warp a shuffle tree (for NV == 32 a transposing butterfly, 31 shuffles
// for the 32 values), the warp's sums into part ([kWarps][NV], this
// CTA's), one cluster.sync(), then every rank's part read through
// distributed shared memory and added rank by rank, warp by warp. Every
// CTA gets the same sums bit for bit, with no atomics. nv <= NV <= 32;
// v is consumed. Every thread of every CTA must call it; it ends with a
// __syncthreads(). A CTA writes part before it waits at the
// cluster.sync(), so two calls on the same part need another
// cluster.sync() between them, or the caller alternates two buffers.
template <int NV, int kWarps, int kCluster>
__device__ void cluster_sum(cooperative_groups::cluster_group& cluster,
                            float (&v)[NV], int nv, float (*part)[NV],
                            float* out) {
  static_assert(NV <= 32, "one value per lane");
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if constexpr (NV == 32) {
    fold<16>(v, lane & 16);
    fold<8>(v, lane & 8);
    fold<4>(v, lane & 4);
    fold<2>(v, lane & 2);
    fold<1>(v, lane & 1);
    part[warp][lane] = v[0];             // the warp's sum of v[lane]
  } else {
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      float x = v[k];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xFFFFFFFFu, x, o);
      if (lane == 0) part[warp][k] = x;
    }
  }
  cluster.sync();
  if (threadIdx.x < nv) {
    float s = 0.0f;
#pragma unroll
    for (int r = 0; r < kCluster; ++r) {
      const float(*rp)[NV] = cluster.map_shared_rank(part, r);
#pragma unroll
      for (int w = 0; w < kWarps; ++w) s += rp[w][threadIdx.x];
    }
    out[threadIdx.x] = s;
  }
  __syncthreads();
}

// T_out = orthonormalize(exp(xi) @ T) for row-major 4x4 poses,
// xi = [rho(3), phi(3)] (the JAX package's se3.exp, compose and
// Gram-Schmidt normalize, as the Pallas solvers inline them).
__device__ inline void se3_left_update(const float* xi, const float* T,
                                       float* T_out) {
  const float px = xi[3], py = xi[4], pz = xi[5];
  const float th2 = px * px + py * py + pz * pz;
  const float th = sqrtf(fmaxf(th2, 1e-24f));
  const bool small = th2 < 1e-8f;
  const float t2s = small ? 1.0f : th2;
  const float a = small ? 1.0f - th2 / 6.0f : sinf(th) / th;
  const float b = small ? 0.5f - th2 / 24.0f : (1.0f - cosf(th)) / t2s;
  const float c = small ? 1.0f / 6.0f - th2 / 120.0f : (1.0f - a) / t2s;
  const float W[3][3] = {{0.0f, -pz, py}, {pz, 0.0f, -px}, {-py, px, 0.0f}};
  float E[4][4];
  for (int i = 0; i < 3; ++i) {
    for (int j = 0; j < 3; ++j) {
      const float ww = W[i][0] * W[0][j] + W[i][1] * W[1][j] + W[i][2] * W[2][j];
      const float eye = i == j ? 1.0f : 0.0f;
      E[i][j] = eye + a * W[i][j] + b * ww;
    }
  }
  for (int i = 0; i < 3; ++i) {
    float t = 0.0f;
    for (int j = 0; j < 3; ++j) {
      const float ww = W[i][0] * W[0][j] + W[i][1] * W[1][j] + W[i][2] * W[2][j];
      const float v = (i == j ? 1.0f : 0.0f) + b * W[i][j] + c * ww;
      t += v * xi[j];
    }
    E[i][3] = t;
  }
  E[3][0] = E[3][1] = E[3][2] = 0.0f;
  E[3][3] = 1.0f;
  float P[4][4];
  for (int i = 0; i < 4; ++i)
    for (int j = 0; j < 4; ++j)
      P[i][j] = E[i][0] * T[j] + E[i][1] * T[4 + j] + E[i][2] * T[8 + j] +
                E[i][3] * T[12 + j];
  // Gram-Schmidt on the rotation columns
  float x0 = P[0][0], x1 = P[1][0], x2 = P[2][0];
  float s = rsqrtf(x0 * x0 + x1 * x1 + x2 * x2 + 1e-24f);
  x0 *= s; x1 *= s; x2 *= s;
  float y0 = P[0][1], y1 = P[1][1], y2 = P[2][1];
  const float dxy = x0 * y0 + x1 * y1 + x2 * y2;
  y0 -= dxy * x0; y1 -= dxy * x1; y2 -= dxy * x2;
  s = rsqrtf(y0 * y0 + y1 * y1 + y2 * y2 + 1e-24f);
  y0 *= s; y1 *= s; y2 *= s;
  const float z0 = x1 * y2 - x2 * y1;
  const float z1 = x2 * y0 - x0 * y2;
  const float z2 = x0 * y1 - x1 * y0;
  const float R[3][3] = {{x0, y0, z0}, {x1, y1, z1}, {x2, y2, z2}};
  for (int i = 0; i < 3; ++i) {
    for (int j = 0; j < 3; ++j) T_out[i * 4 + j] = R[i][j];
    T_out[i * 4 + 3] = P[i][3];
  }
  T_out[12] = T_out[13] = T_out[14] = 0.0f;
  T_out[15] = 1.0f;
}

}  // namespace slam
