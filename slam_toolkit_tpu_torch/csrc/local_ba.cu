// Local bundle adjustment: the whole Levenberg-Marquardt solve in one
// launch of one thread-block cluster.
//
// Replaces slam_toolkit_tpu/ops/ba_kernel.py::_ba_pallas (the
// pl.pallas_call at ba_kernel.py:408). Same semantics as the plain
// solver optim/local_ba.solve_ba: W keyframe poses x P landmarks, 3-row
// stereo edges (u, v, u_right), Huber IRLS with a hard sigma trim and
// the behind-camera penalty; per iteration the Schur complement over the
// point blocks (closed-form 3x3 inverses, the (6W x 6W) reduced camera
// system including S_off = (Hpl Hll^-1) Hpl^T, a Jacobi-scaled unpivoted
// Gauss-Jordan solve with +-1e-12 pivot clamps, back-substitution), the
// SE3 update of the free poses, and the finite-and-cost accept test.
// Fixed or invalid poses get identity rows; points that are not free
// (anchored outside the window) add only pose edges. On the main path it
// solves W = 8, P = 1024 for 10 iterations once per keyframe.
//
// What bounds it on an H100: latency. The inputs are ~0.25 MB and the
// arithmetic ~0.2 GFLOP in all (about 3 us at the f32 peak), but each
// iteration is a chain of dependent phases: the edge pass, the Schur
// terms, a reduction over all points, a 48-step serial solve and the
// trial cost.
//
// Design: one cluster of 8 CTAs (the portable cluster size; up to 1,136
// points fit at W = 8), 256 threads each. The points are split into 8
// contiguous ranges; a CTA keeps everything about its points in shared
// memory for the whole solve (edge inputs, current and trial X, per edge
// the 6x3 Hpl block and A = Hpl Hll^-1, per point Hll^-1 and bl), so
// nothing goes through global memory between phases. Per iteration:
// - Edge pass: warp w owns pose w, lanes stride over the CTA's points;
//   each lane keeps its 27 Hpp / bp terms of pose w in registers, a
//   shuffle tree sums them. Per edge Hpl goes to shared memory, and the
//   edge's Hll and bl terms into the slot A takes later.
// - Point pass: a thread per point sums its W edges' Hll and bl (in w
//   order), inverts in closed form (+-1e-12 determinant clamp) and
//   overwrites its slots with A. Warp w then sums the rhs coupling A bl
//   of pose w, and 208 threads form this CTA's part of the upper
//   triangle of S_off (2x3 register blocks of the 36 pose pairs;
//   per-pose strides padded to 6 mod 32 banks, so the pose blocks a
//   warp reads fall in different banks).
// - Reduction: the 264 pose sums and 1,176 S_off entries of every CTA
//   are read through distributed shared memory after one cluster.sync()
//   and summed in rank order by every CTA: all 8 hold the same reduced
//   system bit for bit, with no atomics and no broadcast. One buffer of
//   partials suffices: the trial cost's cluster.sync() separates this
//   iteration's remote reads from the next iteration's writes.
// - Solve: every CTA assembles S (the lower triangle mirrors S_off's
//   upper) and runs the Gauss-Jordan with the matrix in registers, 245
//   threads each holding a tenth of a column, one barrier a step, no
//   branch in a step; W < 8 pads the system with identity rows. Each element update is the one-block kernel's arithmetic, in
//   the same pose-major row order.
// - Every CTA forms the trial poses from the same dp, back-substitutes
//   its own points, and a second cluster reduction in rank order of
//   [trial cost, observations in front, non-finite flag]
//   (slam::cluster_sum) gives every CTA the same accept decision and
//   damping.
// A final cluster.sync() keeps every CTA resident until no other can
// still read its shared memory. Given a phase_cycles buffer, thread 0 of
// rank 0 adds up the clock64() cycles of each phase (see Phase), read at
// the barriers that end them, and writes them there at exit.
//
// The batched entry solves B problems of the same W and P in one launch,
// one cluster a problem (the JAX package's vmapped _ba_pallas): the grid
// is (8, B), the cluster's lane blockIdx.y, whose pointers are offset to
// its b-th problem before the single launch's body runs, so each lane's
// solve is its single launch's bit for bit. A lane whose entry of the
// int32 mask `lanes` is 0 writes nothing: every CTA of its cluster reads
// the mask first, before any cluster.sync() or distributed shared-memory
// access, and all 8 return together.
#include <cooperative_groups.h>
#include <math.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kCluster = 8;            // CTAs: the portable cluster size
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxW = 8;
constexpr int kN = 6 * kMaxW;          // rows of the (padded) reduced system
constexpr int kTerms = 33;             // per pose: 21 Hpp, 6 bp, 6 rhs coupling
constexpr int kSumsLen = kMaxW * kTerms;
constexpr int kPart = kSumsLen + kN * (kN + 1) / 2;  // + S_off upper triangle
constexpr int kBlk = 18;               // a 6x3 block per edge, [c][a]
constexpr int kEdgeF = 6;              // per edge: z (3), 1/sigma, obs, stereo
constexpr int kPtF = 12;               // per point: Hll^-1 (6), bl (3), act, valid, free
constexpr int kPairs = kMaxW * (kMaxW + 1) / 2;       // pose pairs wi <= wj
constexpr int kSubs = 6;               // 2x3 blocks of a pair's 6x6 S_off block
constexpr int kGJGroups = 5;           // row groups of a solve column
constexpr int kGJThreads = (kN + 1) * kGJGroups;     // 245 of the 256
constexpr int kGJRows = (kN + kGJGroups - 1) / kGJGroups;
constexpr int kGJPad = kGJRows * kGJGroups;          // 50 rows
constexpr unsigned kFull = 0xFFFFFFFFu;
// Phases whose clock64() cycles rank 0's thread 0 adds up when the caller
// asks for them: set-up and first cost, then per iteration 1-9 in the
// order below, then the outputs.
enum Phase {
  kSetup, kEdgePass, kPointPass, kPartials, kReduce, kAssemble, kSolve,
  kBackSub, kTrialCost, kAccept, kOutputs, kPhases
};

struct Params {
  int W, P, iters;
  float delta, lam0, lam_up, lam_down, trim;
};

// Points per CTA and the shared-memory layout (in floats) for W, P.
struct Layout {
  int pc;     // point slots per CTA
  int ws;     // per-pose stride of the 6x3 block arrays
  int floats;
  __host__ __device__ Layout(int W, int P) {
    pc = (P + kCluster - 1) / kCluster;
    ws = pc * kBlk + (((6 - pc * kBlk) % 32) + 32) % 32;   // == 6 mod 32
    floats = 2 * W * ws + kEdgeF * W * pc + 6 * pc + kPtF * pc;
  }
};

struct Edge {
  float x, y, zc, iz, r0, r1, r2, w0, w2;
};

__device__ __forceinline__ Edge edge_at(const float* T, float X0, float X1,
                                        float X2, float z0, float z1,
                                        float z2, float isg, float ow,
                                        float sw, float bl) {
  Edge e;
  e.x = T[0] * X0 + T[1] * X1 + T[2] * X2 + T[3];
  e.y = T[4] * X0 + T[5] * X1 + T[6] * X2 + T[7];
  e.zc = T[8] * X0 + T[9] * X1 + T[10] * X2 + T[11];
  const bool good = e.zc > 1e-3f;
  e.iz = 1.0f / (good ? e.zc : 1.0f);
  e.r0 = (e.x * e.iz - z0) * isg;
  e.r1 = (e.y * e.iz - z1) * isg;
  e.r2 = ((e.x - bl) * e.iz - z2) * isg;
  e.w0 = good ? ow : 0.0f;
  e.w2 = good ? ow * sw : 0.0f;
  return e;
}

__device__ __forceinline__ float edge_norm(const Edge& e) {
  return sqrtf(e.r0 * e.r0 * e.w0 + e.r1 * e.r1 * e.w0 +
               e.r2 * e.r2 * e.w2 + 1e-12f);
}

__device__ __forceinline__ float huber(float rn, float delta) {
  return rn <= delta ? 0.5f * rn * rn : delta * (rn - 0.5f * delta);
}

// This CTA's edges in shared memory: field f of edge (w, q) at
// e[f * W * pc + w * pc + q].
struct Edges {
  const float* e;
  int wp, pc;
  __device__ __forceinline__ Edge at(const float* T, int w, int q, float X0,
                                     float X1, float X2, float bl) const {
    const int i = w * pc + q;
    return edge_at(T, X0, X1, X2, e[i], e[wp + i], e[2 * wp + i],
                   e[3 * wp + i], e[4 * wp + i], e[5 * wp + i], bl);
  }
  __device__ __forceinline__ float ow(int w, int q) const {
    return e[4 * wp + w * pc + q];
  }
};

// This thread's share of [sum of trimmed Huber costs over active edges,
// sum of w0 (observations in front of their camera)] over the CTA's np
// points X ([3][pc]) at poses T.
__device__ void cost_terms(const float (*T)[16], const float* X,
                           const Edges& E, int W, int np, float bl,
                           const Params& prm, float (&acc)[3]) {
  const float c_trim = huber(prm.trim, prm.delta);
  acc[0] = acc[1] = 0.0f;
  for (int q = threadIdx.x; q < np; q += kThreads) {
    const float X0 = X[q], X1 = X[E.pc + q], X2 = X[2 * E.pc + q];
    for (int w = 0; w < W; ++w) {
      const Edge e = E.at(T[w], w, q, X0, X1, X2, bl);
      const float rn = edge_norm(e);
      const float c = rn <= prm.trim ? huber(rn, prm.delta) : c_trim;
      if (e.w0 > 0.0f) acc[0] += c;
      acc[1] += e.w0;
    }
  }
}

// Closed-form symmetric 3x3 inverse (ba_kernel.py _inv3_rows):
// h = (h00, h01, h02, h11, h12, h22) -> the same six entries of the inverse.
__device__ __forceinline__ void inv3_sym(const float (&h)[6], float (&o)[6]) {
  const float m00 = h[3] * h[5] - h[4] * h[4];
  const float m01 = h[2] * h[4] - h[1] * h[5];
  const float m02 = h[1] * h[4] - h[2] * h[3];
  const float m11 = h[0] * h[5] - h[2] * h[2];
  const float m12 = h[1] * h[2] - h[0] * h[4];
  const float m22 = h[0] * h[3] - h[1] * h[1];
  float det = h[0] * m00 + h[1] * m01 + h[2] * m02;
  if (fabsf(det) < 1e-12f) det = det < 0.0f ? -1e-12f : 1e-12f;
  const float i = 1.0f / det;
  o[0] = m00 * i; o[1] = m01 * i; o[2] = m02 * i;
  o[3] = m11 * i; o[4] = m12 * i; o[5] = m22 * i;
}

__device__ __forceinline__ float sym3(const float (&h)[6], int a, int b) {
  const int lo = a < b ? a : b, hi = a < b ? b : a;
  return h[lo == 0 ? hi : (lo == 1 ? 2 + hi : 5)];
}

// Index of (a, b), a <= b, in the row-major upper triangle of an n x n.
__device__ __forceinline__ int tri(int a, int b, int n) {
  if (a > b) { const int t = a; a = b; b = t; }
  return a * n - a * (a - 1) / 2 + (b - a);
}

// Jacobi-scaled, unpivoted Gauss-Jordan of the (kN x kN+1) augmented
// system M (the rhs is column kN) by the block, one barrier a step:
// thread (j, g) = (tid / kGJGroups, tid % kGJGroups) keeps column j of
// rows g, g + kGJGroups, ... in registers (rows padded to kGJPad, so a
// step has no branch: the padding rows stay out of every real row and
// column); after each step the owners of the next pivot row and column
// publish them to the other half of the ping-pong buffers rowb / colb.
// Writes dp[i] = x[i] * fp[i / 6]. Every thread must call it.
__device__ __forceinline__ void gauss_jordan(const float (*M)[kN + 1],
                                             const float* fp,
                                             float (*rowb)[kN + 1],
                                             float (*colb)[kGJPad],
                                             float* dp) {
  const int tid = threadIdx.x;
  const bool on = tid < kGJThreads;
  const int j = tid / kGJGroups, g = tid - j * kGJGroups;
  const float dj = on && j < kN ? rsqrtf(fmaxf(M[j][j], 1e-30f)) : 1.0f;
  float v[kGJRows];
#pragma unroll
  for (int m = 0; m < kGJRows; ++m) {
    const int i = g + kGJGroups * m;
    v[m] = 0.0f;
    if (on && i < kN) {
      const float di = rsqrtf(fmaxf(M[i][i], 1e-30f));
      v[m] = j < kN ? M[i][j] * di * dj : M[i][kN] * di;
      if (i == 0) rowb[0][j] = v[m];
    }
    if (on && j == 0) colb[0][i] = v[m];
  }
  __syncthreads();
  for (int k = 0; k < kN; ++k) {
    const int b = k & 1;
    if (on) {
      float piv = colb[b][k];
      if (fabsf(piv) < 1e-12f) piv = piv < 0.0f ? -1e-12f : 1e-12f;
      const float r = rowb[b][j] / piv;
      float c[kGJRows];
#pragma unroll
      for (int m = 0; m < kGJRows; ++m) c[m] = colb[b][g + kGJGroups * m];
      float next = 0.0f;          // this thread's entry of row k + 1
#pragma unroll
      for (int m = 0; m < kGJRows; ++m) {
        const int i = g + kGJGroups * m;
        v[m] = i == k ? r : v[m] - c[m] * r;
        next = i == k + 1 ? v[m] : next;
      }
      if (g == (k + 1) % kGJGroups) rowb[b ^ 1][j] = next;
      if (j == k + 1) {
#pragma unroll
        for (int m = 0; m < kGJRows; ++m) colb[b ^ 1][g + kGJGroups * m] = v[m];
      }
    }
    __syncthreads();
  }
  if (on && j == kN) {
#pragma unroll
    for (int m = 0; m < kGJRows; ++m) {
      const int i = g + kGJGroups * m;
      if (i < kN) dp[i] = v[m] * rsqrtf(fmaxf(M[i][i], 1e-30f)) * fp[i / 6];
    }
  }
}

__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads, 1)
local_ba_kernel(const float* __restrict__ T_in, const float* __restrict__ FP,
                const float* __restrict__ X_in, const float* __restrict__ Z,
                const float* __restrict__ ISG, const float* __restrict__ OW,
                const float* __restrict__ SW, const float* __restrict__ PV,
                const float* __restrict__ PF,
                const float* __restrict__ baseline, Params prm,
                const int* __restrict__ lanes, float* __restrict__ T_out,
                float* __restrict__ X_out, float* __restrict__ cost_out,
                float* __restrict__ r2_out,
                long long* __restrict__ phase_cycles) {
  // every CTA of the cluster reads the same entry and leaves together
  if (lanes != nullptr && lanes[blockIdx.y] == 0) return;
  {
    // this cluster's problem of a batched launch (0 for a single one)
    const size_t b = blockIdx.y, W = prm.W, P = prm.P;
    T_in += b * W * 16;
    FP += b * W;
    X_in += b * P * 3;
    Z += b * W * P * 3;
    ISG += b * W * P;
    OW += b * W * P;
    SW += b * W * P;
    PV += b * P;
    PF += b * P;
    T_out += b * W * 16;
    X_out += b * P * 3;
    cost_out += b;
    r2_out += b * W * P;
  }
  extern __shared__ float dyn[];
  __shared__ float sT[kMaxW][16], sTtry[kMaxW][16];
  __shared__ float sFp[kMaxW];
  // This CTA's partials. The other CTAs read them in step 4, after the
  // cluster.sync() that ends step 3; this CTA rewrites them (steps 1 and
  // 3 of the next iteration) only after the cluster.sync() of step 7's
  // cost reduction, which no CTA passes before every CTA has finished
  // step 4: one buffer does. The cost partials likewise: read after step
  // 7's cluster.sync(), rewritten after the next step 3's.
  __shared__ float sPart[kPart];
  __shared__ float sRed[kPart];          // the cluster's sums
  __shared__ float sCost[kWarps][3];     // this CTA's cost partials
  __shared__ float sCostRed[3];
  __shared__ float sM[kN][kN + 1];
  __shared__ float sRowB[2][kN + 1], sColB[2][kGJPad];   // solve's pivots
  __shared__ float sDp[kN];

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int W = prm.W, P = prm.P, n6 = 6 * W;
  const Layout lay(W, P);
  const int pc = lay.pc, ws = lay.ws, wp = W * pc;
  const int p0 = rank * pc;
  const int np = max(0, min(pc, P - p0));     // points this CTA owns
  float* hpl = dyn;                           // [W][ws]: [q][c][a]
  float* ahi = hpl + W * ws;                  // A; first the edge Hll, bl
  float* edg = ahi + W * ws;                  // [kEdgeF][W][pc]
  float* xs = edg + kEdgeF * wp;              // [2][3][pc] current / trial
  float* pts = xs + 6 * pc;                   // [kPtF][pc]
  const Edges E{edg, wp, pc};
  const float bl = baseline[0];
  const float delta = prm.delta;
  const float behind_pen = delta * (1e3f - 0.5f * delta);
  // per-phase cycles, counted at the barrier that ends each phase
  const bool clocked = phase_cycles != nullptr && rank == 0 && tid == 0 &&
                       blockIdx.y == 0;
  long long cycles[kPhases] = {};
  long long t_mark = clock64();
  auto mark = [&](Phase ph) {
    if (clocked) {
      const long long t = clock64();
      cycles[ph] += t - t_mark;
      t_mark = t;
    }
  };

  // ---- load this CTA's points and edges
  for (int i = tid; i < W * 16; i += kThreads) sT[i / 16][i % 16] = T_in[i];
  if (tid < kMaxW) sFp[tid] = tid < W ? FP[tid] : 0.0f;
  for (int i = tid; i < kPart; i += kThreads) sPart[i] = 0.0f;
  for (int i = tid; i < wp; i += kThreads) {
    const int w = i / pc, q = i - w * pc;
    if (q < np) {
      const size_t g = static_cast<size_t>(w) * P + p0 + q;
      edg[i] = Z[g * 3];
      edg[wp + i] = Z[g * 3 + 1];
      edg[2 * wp + i] = Z[g * 3 + 2];
      edg[3 * wp + i] = ISG[g];
      edg[4 * wp + i] = OW[g];
      edg[5 * wp + i] = SW[g];
    }
  }
  for (int q = tid; q < np; q += kThreads) {
    const int p = p0 + q;
    bool seen = false;
    for (int w = 0; w < W; ++w) seen = seen || OW[static_cast<size_t>(w) * P + p] > 0.0f;
    for (int k = 0; k < 3; ++k) xs[k * pc + q] = X_in[p * 3 + k];
    pts[9 * pc + q] = PV[p] * PF[p] > 0.0f && seen ? 1.0f : 0.0f;
    pts[10 * pc + q] = PV[p];
    pts[11 * pc + q] = PF[p];
  }
  __syncthreads();

  int cur = 0;                 // current X buffer
  float cost, ow_sum;          // every thread holds the same values
  {
    float c3[3];
    cost_terms(sT, xs, E, W, np, bl, prm, c3);
    c3[2] = 0.0f;
    for (int i = tid; i < W * np; i += kThreads) c3[2] += E.ow(i / np, i % np);
    slam::cluster_sum<3, kWarps, kCluster>(cluster, c3, 3, sCost, sCostRed);
    ow_sum = sCostRed[2];
    cost = sCostRed[0] + behind_pen * (sCostRed[2] - sCostRed[1]);
  }
  float lam = prm.lam0;
  mark(kSetup);

  for (int it = 0; it < prm.iters; ++it) {
    const float* Xc = xs + cur * 3 * pc;
    float* Xt = xs + (cur ^ 1) * 3 * pc;

    // ---- 1. edge pass: warp w = pose w; Hpp, bp sums; Hpl; edge Hll, bl
    if (warp < W) {
      const int w = warp;
      const float* T = sT[w];
      float acc[27];
#pragma unroll
      for (int k = 0; k < 27; ++k) acc[k] = 0.0f;
      for (int q = lane; q < np; q += 32) {
        const int i = w * pc + q;
        const float isg = edg[3 * wp + i];
        const Edge e = E.at(T, w, q, Xc[q], Xc[pc + q], Xc[2 * pc + q], bl);
        const float rn = edge_norm(e);
        const float keep = rn <= prm.trim ? 1.0f : 0.0f;
        const float hub = fminf(1.0f, delta / fmaxf(rn, 1e-12f)) * keep;
        const float v0 = e.w0 * hub, v2 = e.w2 * hub;
        const float iz2 = e.iz * e.iz;
        const float xb = e.x - bl;
        // d(pi)/d(Xc) rows scaled by 1/sigma, then Jp = [dpi | -dpi hat(Xc)]
        const float d[3][3] = {{e.iz * isg, 0.0f, -e.x * iz2 * isg},
                               {0.0f, e.iz * isg, -e.y * iz2 * isg},
                               {e.iz * isg, 0.0f, -xb * iz2 * isg}};
        float jp[3][6], jl[3][3];
#pragma unroll
        for (int r = 0; r < 3; ++r) {
          const float c0 = d[r][0], c1 = d[r][1], c2 = d[r][2];
          jp[r][0] = c0; jp[r][1] = c1; jp[r][2] = c2;
          jp[r][3] = -(c1 * e.zc - c2 * e.y);
          jp[r][4] = -(-c0 * e.zc + c2 * e.x);
          jp[r][5] = -(c0 * e.y - c1 * e.x);
#pragma unroll
          for (int j = 0; j < 3; ++j)
            jl[r][j] = c0 * T[j] + c1 * T[4 + j] + c2 * T[8 + j];
        }
        const float rr[3] = {e.r0, e.r1, e.r2};
        int k = 0;
#pragma unroll
        for (int a = 0; a < 6; ++a) {
#pragma unroll
          for (int b = a; b < 6; ++b) {
            acc[k++] += v0 * (jp[0][a] * jp[0][b] + jp[1][a] * jp[1][b]) +
                        v2 * jp[2][a] * jp[2][b];
          }
        }
#pragma unroll
        for (int a = 0; a < 6; ++a) {
          acc[21 + a] += -(v0 * (jp[0][a] * rr[0] + jp[1][a] * rr[1]) +
                           v2 * jp[2][a] * rr[2]);
        }
        // point blocks: free points only
        const float pf = pts[11 * pc + q];
        const float v0l = v0 * pf, v2l = v2 * pf;
        float* hl = ahi + w * ws + q * kBlk;     // the edge's Hll (6), bl (3)
        k = 0;
#pragma unroll
        for (int a = 0; a < 3; ++a) {
#pragma unroll
          for (int b = a; b < 3; ++b) {
            hl[k++] = v0l * (jl[0][a] * jl[0][b] + jl[1][a] * jl[1][b]) +
                      v2l * jl[2][a] * jl[2][b];
          }
          hl[6 + a] = -(v0l * (jl[0][a] * rr[0] + jl[1][a] * rr[1]) +
                        v2l * jl[2][a] * rr[2]);
        }
        float* hp = hpl + w * ws + q * kBlk;
#pragma unroll
        for (int a = 0; a < 6; ++a) {
#pragma unroll
          for (int b = 0; b < 3; ++b) {
            hp[b * 6 + a] = v0l * (jp[0][a] * jl[0][b] + jp[1][a] * jl[1][b]) +
                            v2l * jp[2][a] * jl[2][b];
          }
        }
      }
#pragma unroll
      for (int k = 0; k < 27; ++k) {
        float x = acc[k];
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
        if (lane == 0) sPart[w * kTerms + k] = x;
      }
    }
    __syncthreads();
    mark(kEdgePass);

    // ---- 2. point pass: Hll^-1 and bl per point, then A = Hpl Hll^-1
    for (int q = tid; q < np; q += kThreads) {
      float hll[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
      float blv[3] = {0.0f, 0.0f, 0.0f};
      for (int w = 0; w < W; ++w) {
        const float* hl = ahi + w * ws + q * kBlk;
#pragma unroll
        for (int k = 0; k < 6; ++k) hll[k] += hl[k];
#pragma unroll
        for (int k = 0; k < 3; ++k) blv[k] += hl[6 + k];
      }
      // damping and the guard for empty / fixed / invalid points
      const bool act = pts[9 * pc + q] > 0.0f;
      float h[6], hi[6];
      h[0] = act ? hll[0] * (1.0f + lam) + 1e-4f : 1.0f;
      h[1] = act ? hll[1] : 0.0f;
      h[2] = act ? hll[2] : 0.0f;
      h[3] = act ? hll[3] * (1.0f + lam) + 1e-4f : 1.0f;
      h[4] = act ? hll[4] : 0.0f;
      h[5] = act ? hll[5] * (1.0f + lam) + 1e-4f : 1.0f;
      if (!act) blv[0] = blv[1] = blv[2] = 0.0f;
      inv3_sym(h, hi);
#pragma unroll
      for (int k = 0; k < 6; ++k) pts[k * pc + q] = hi[k];
#pragma unroll
      for (int k = 0; k < 3; ++k) pts[(6 + k) * pc + q] = blv[k];
      for (int w = 0; w < W; ++w) {
        const float* hp = hpl + w * ws + q * kBlk;
        float* A = ahi + w * ws + q * kBlk;
#pragma unroll
        for (int a = 0; a < 6; ++a) {
          const float h0 = hp[a], h1 = hp[6 + a], h2 = hp[12 + a];
#pragma unroll
          for (int c = 0; c < 3; ++c) {
            A[c * 6 + a] = h0 * sym3(hi, 0, c) + h1 * sym3(hi, 1, c) +
                           h2 * sym3(hi, 2, c);
          }
        }
      }
    }
    __syncthreads();
    mark(kPointPass);

    // ---- 3. this CTA's partials: rhs coupling (A bl) per pose, S_off
    if (warp < W) {
      const int w = warp;
      float rc[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
      for (int q = lane; q < np; q += 32) {
        const float* A = ahi + w * ws + q * kBlk;
        const float b0 = pts[6 * pc + q], b1 = pts[7 * pc + q],
                    b2 = pts[8 * pc + q];
#pragma unroll
        for (int a = 0; a < 6; ++a) rc[a] += A[a] * b0 + A[6 + a] * b1 + A[12 + a] * b2;
      }
#pragma unroll
      for (int a = 0; a < 6; ++a) {
        float x = rc[a];
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
        if (lane == 0) sPart[w * kTerms + 27 + a] = x;
      }
    }
    if (tid < kPairs * kSubs) {
      int wi = 0, rem = tid / kSubs;
      while (rem >= kMaxW - wi) {
        rem -= kMaxW - wi;
        ++wi;
      }
      const int wj = wi + rem;
      const int a0 = (tid % kSubs) / 2 * 2, b0 = (tid % 2) * 3;
      if (wj < W && !(wi == wj && a0 > b0 + 2)) {
        float so[2][3] = {{0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f}};
        const float* Ai = ahi + wi * ws + a0;
        const float* Hj = hpl + wj * ws + b0;
        for (int q = 0; q < np; ++q) {
#pragma unroll
          for (int c = 0; c < 3; ++c) {
            const int o = q * kBlk + c * 6;
            const float x0 = Ai[o], x1 = Ai[o + 1];
            const float y0 = Hj[o], y1 = Hj[o + 1], y2 = Hj[o + 2];
            so[0][0] += x0 * y0; so[0][1] += x0 * y1; so[0][2] += x0 * y2;
            so[1][0] += x1 * y0; so[1][1] += x1 * y1; so[1][2] += x1 * y2;
          }
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
#pragma unroll
          for (int t = 0; t < 3; ++t) {
            const int i = 6 * wi + a0 + r, j = 6 * wj + b0 + t;
            if (i <= j) sPart[kSumsLen + tri(i, j, n6)] = so[r][t];
          }
        }
      }
    }
    cluster.sync();
    mark(kPartials);

    // ---- 4. every CTA sums the 8 ranks' partials in rank order
    const int n_part = kSumsLen + n6 * (n6 + 1) / 2;
    for (int e = tid; e < n_part; e += kThreads) {
      float s = 0.0f;
#pragma unroll
      for (int r = 0; r < kCluster; ++r) s += cluster.map_shared_rank(sPart, r)[e];
      sRed[e] = s;
    }
    __syncthreads();
    mark(kReduce);

    // ---- 5. S = Hpp_d - S_off with frozen rows and the rhs, padded to kN
    for (int e = tid; e < kN * (kN + 1); e += kThreads) {
      const int i = e / (kN + 1), j = e - i * (kN + 1);
      float v;
      if (i >= n6) {
        v = j == i ? 1.0f : 0.0f;
      } else if (j == kN) {
        const int w = i / 6, a = i % 6;
        v = (sRed[w * kTerms + 21 + a] - sRed[w * kTerms + 27 + a]) * sFp[w];
      } else if (j >= n6) {
        v = 0.0f;
      } else {
        const int wi = i / 6, a = i % 6, wj = j / 6, b = j % 6;
        v = -sRed[kSumsLen + tri(i, j, n6)];
        if (wi == wj) {
          float hv = sRed[wi * kTerms + tri(a, b, 6)];
          if (a == b) hv = hv * (1.0f + lam) + 1e-6f;
          v += hv;
        }
        v = v * sFp[wi] * sFp[wj];
        if (i == j) v += 1.0f - sFp[wi];
      }
      sM[i][j] = v;
    }
    __syncthreads();
    mark(kAssemble);
    gauss_jordan(sM, sFp, sRowB, sColB, sDp);
    __syncthreads();
    mark(kSolve);

    // ---- 6. back-substitution of this CTA's points, trial poses
    int bad = 0;
    for (int q = tid; q < np; q += kThreads) {
      float hi[6], t[3];
#pragma unroll
      for (int k = 0; k < 6; ++k) hi[k] = pts[k * pc + q];
      const bool act = pts[9 * pc + q] > 0.0f;
#pragma unroll
      for (int b = 0; b < 3; ++b) {
        float hd = 0.0f;
        for (int w = 0; w < W; ++w) {
          const float* hp = hpl + w * ws + q * kBlk + b * 6;
          float v = 0.0f;
#pragma unroll
          for (int a = 0; a < 6; ++a) v += hp[a] * sDp[w * 6 + a];
          hd += v;
        }
        t[b] = pts[(6 + b) * pc + q] - hd;
      }
      const float pv = pts[10 * pc + q];
#pragma unroll
      for (int b = 0; b < 3; ++b) {
        float dl = sym3(hi, b, 0) * t[0] + sym3(hi, b, 1) * t[1] +
                   sym3(hi, b, 2) * t[2];
        dl = act ? dl : 0.0f;
        bad |= !isfinite(dl);
        Xt[b * pc + q] = Xc[b * pc + q] + dl * pv;
      }
    }
    if (tid < n6) bad |= !isfinite(sDp[tid]);
    if (tid < W) {
      if (sFp[tid] > 0.0f) {
        slam::se3_left_update(sDp + tid * 6, sT[tid], sTtry[tid]);
      } else {
        for (int k = 0; k < 16; ++k) sTtry[tid][k] = sT[tid][k];
      }
    }
    __syncthreads();
    mark(kBackSub);

    // ---- 7. trial cost and the non-finite flag over the cluster
    {
      float c3[3];
      cost_terms(sTtry, Xt, E, W, np, bl, prm, c3);
      c3[2] = bad ? 1.0f : 0.0f;
      slam::cluster_sum<3, kWarps, kCluster>(cluster, c3, 3, sCost, sCostRed);
    }
    mark(kTrialCost);
    const float cost_try = sCostRed[0] + behind_pen * (ow_sum - sCostRed[1]);
    const bool accept = sCostRed[2] == 0.0f && cost_try < cost;
    if (accept) {
      for (int i = tid; i < W * 16; i += kThreads) sT[i / 16][i % 16] = sTtry[i / 16][i % 16];
      cost = cost_try;
      cur ^= 1;
      lam = fmaxf(lam * prm.lam_down, 1e-7f);
    } else {
      lam = lam * prm.lam_up;
    }
    __syncthreads();
    mark(kAccept);
  }

  // ---- final edge r2 and points of this CTA; poses and cost from rank 0
  const float* Xc = xs + cur * 3 * pc;
  for (int q = tid; q < np; q += kThreads) {
    const int p = p0 + q;
    const float X0 = Xc[q], X1 = Xc[pc + q], X2 = Xc[2 * pc + q];
    for (int w = 0; w < W; ++w) {
      const Edge e = E.at(sT[w], w, q, X0, X1, X2, bl);
      r2_out[static_cast<size_t>(w) * P + p] =
          e.r0 * e.r0 * e.w0 + e.r1 * e.r1 * e.w0 + e.r2 * e.r2 * e.w2;
    }
    X_out[p * 3] = X0;
    X_out[p * 3 + 1] = X1;
    X_out[p * 3 + 2] = X2;
  }
  if (rank == 0) {
    for (int i = tid; i < W * 16; i += kThreads) T_out[i] = sT[i / 16][i % 16];
    if (tid == 0) cost_out[0] = cost;
  }
  // no CTA leaves while another may still read its shared memory
  cluster.sync();
  mark(kOutputs);
  if (clocked) {
    for (int k = 0; k < kPhases; ++k) phase_cycles[k] = cycles[k];
  }
}

// Dynamic shared memory a CTA may take on the current device, in bytes.
int dyn_limit_bytes(int* out) {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  cudaFuncAttributes fa;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&fa, local_ba_kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  *out = optin - static_cast<int>(fa.sharedSizeBytes);
  return 0;
}

}  // namespace

// The largest P one cluster holds for a window of W poses (0 if none), or
// -1 on a CUDA error.
SLAM_API int slam_local_ba_max_points(int W) {
  int limit = 0;
  if (W < 1 || W > kMaxW || dyn_limit_bytes(&limit) != 0) return -1;
  int P = 0;
  while (Layout(W, P + kCluster).floats * static_cast<int>(sizeof(float)) <= limit)
    P += kCluster;
  return P;
}

// `problems` problems of the same W and P: T_in (problems, W, 16),
// free_pose (problems, W), X_in (problems, P, 3), Z (problems, W, P, 3),
// inv_sigma, obs_w and stereo_w (problems, W, P), pt_valid and pt_free
// (problems, P), one baseline; T_out, X_out, cost_out and r2_out with the
// same leading axis. lanes: (problems,) int32, 0 for a problem to skip,
// or null for none skipped. phase_cycles (null, or the clocks of problem
// 0) as slam_local_ba's.
SLAM_API int slam_local_ba_batched(
    const float* T_in, const float* free_pose, const float* X_in,
    const float* Z, const float* inv_sigma, const float* obs_w,
    const float* stereo_w, const float* pt_valid, const float* pt_free,
    const float* baseline, int W, int P, int iters, float delta, float lam0,
    float lam_up, float lam_down, float trim, int problems, const int* lanes,
    float* T_out, float* X_out, float* cost_out, float* r2_out,
    long long* phase_cycles, cudaStream_t stream) {
  if (W < 1 || W > kMaxW || P < 1 || iters < 0 || problems < 1 ||
      problems > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // the opt-in above 48 KB: queried and set once per device, so a call
  // inside a CUDA graph capture only launches
  static int limits[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (limits[dev] == 0) {
    int limit = 0;
    const int e = dyn_limit_bytes(&limit);
    if (e != 0) return e;
    err = cudaFuncSetAttribute(local_ba_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               limit);
    if (err != cudaSuccess) return static_cast<int>(err);
    limits[dev] = limit;
  }
  const size_t bytes = Layout(W, P).floats * sizeof(float);
  if (bytes > static_cast<size_t>(limits[dev])) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Params prm{W, P, iters, delta, lam0, lam_up, lam_down, trim};
  local_ba_kernel<<<dim3(kCluster, problems), kThreads, bytes, stream>>>(
      T_in, free_pose, X_in, Z, inv_sigma, obs_w, stereo_w, pt_valid, pt_free,
      baseline, prm, lanes, T_out, X_out, cost_out, r2_out, phase_cycles);
  return static_cast<int>(cudaGetLastError());
}

SLAM_API int slam_local_ba(const float* T_in, const float* free_pose,
                           const float* X_in, const float* Z,
                           const float* inv_sigma, const float* obs_w,
                           const float* stereo_w, const float* pt_valid,
                           const float* pt_free, const float* baseline, int W,
                           int P, int iters, float delta, float lam0,
                           float lam_up, float lam_down, float trim,
                           float* T_out, float* X_out, float* cost_out,
                           float* r2_out, long long* phase_cycles,
                           cudaStream_t stream) {
  return slam_local_ba_batched(T_in, free_pose, X_in, Z, inv_sigma, obs_w,
                               stereo_w, pt_valid, pt_free, baseline, W, P,
                               iters, delta, lam0, lam_up, lam_down, trim, 1,
                               nullptr, T_out, X_out, cost_out, r2_out,
                               phase_cycles, stream);
}
