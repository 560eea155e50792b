// Top-2 Hamming matcher under two pixel-radius gates (r and 2r).
//
// Replaces slam_toolkit_tpu/ops/match_kernel.py::_topk2_pallas (the
// pl.pallas_call at match_kernel.py:139), with the semantics of its
// reference _topk2_xla (match_kernel.py:148-162). On the main path it
// matches M = 3072 landmarks against N = 2048 keypoints every frame.
//
// What bounds it on an H100: integer issue, the pixel gate and __popc.
// The inputs are 160 KB and the output 98 KB, so memory is no limit. The
// dense (M, N) test is 6.3M gates; with r = 50 on 1241x376 only ~7% of
// the pairs lie inside 2r, and only those need a Hamming distance (8 XOR
// + 8 __popc, and __popc issues at 16 a clock per SM against 128 float32
// operations). A warp that runs the Hamming whenever any of its 32 lanes
// passes the gate pays it on almost every step.
//
// Design, in one launch:
// 1. Every block bins the N keypoints into a grid in shared memory: the
//    bounding box of the keypoints within +-1e6 px cut into square cells
//    of about r/2 (at most kMaxCells cells), with one ring of outer bins
//    per side (beyond the box, and beyond +-1e6 px, where the callers'
//    +-1e7 sentinels for invalid slots and invisible landmarks fall).
//    A keypoint with a NaN coordinate passes no gate and goes into no
//    bin. The block counts keypoints per cell (shared atomics), takes an
//    exclusive prefix sum, and scatters (x, y, column) into cell order,
//    so each row of cells is one contiguous range.
// 2. One warp takes one query row at a time. The bins are monotone in
//    the coordinate, and a pair passes the 2r gate only if |du| and |dv|
//    are below reach = sqrt(r2sq) + 1, so the keypoints the gate can pass
//    lie in the cells that [u - reach, u + reach] x [v - reach, v + reach]
//    touches: one contiguous range per row of cells. The grid is only a
//    pre-filter; the exact gate decides every pair it lets through, with
//    the plain version's rounding (__fsub_rn, __fmul_rn, __fadd_rn, no
//    FMA contraction). A query at +1e7 touches only the outer corner bin.
// 3. The lanes test the gate on 32 keypoints of a range at a time and
//    take a __ballot_sync of the passes; the passing columns are appended
//    to the warp's queue in shared memory. Once 32 wait, each lane takes
//    one and computes its Hamming distance (XOR + __popc over the 8
//    words), so the warp runs one Hamming per passing pair, not one per
//    lane-step.
// At M = 3072 each warp has one row, so the time is one block's chain of
// dependent steps (the grid build, then one row), not throughput: the
// build reduces with __reduce_min/max_sync and bins without branches,
// each warp loads its row's coordinates and descriptor before the build
// (the next row's one row ahead), and the rows are spread evenly, one
// block of 24 warps per SM.
// Each lane keeps the best and second-best PACKED keys (ham << 12 |
// column) per gate as integers: one unsigned compare orders by distance
// and then by column, which gives the first-minimum tie order of
// jnp.argmin whatever order the pairs are visited in. The second-best
// excludes only the argbest column, so a tie at the best distance gives
// second = best, as in the reference. Lanes merge by warp shuffles. Rows
// with no candidate report BIG = 1e9 and argbest 0 (argmin of an all-BIG
// row). A block handles 24 rows at a time and the launch is capped at one
// block per SM (48 KB of shared memory, 63 registers a thread), so the
// keypoints are read from L2 once per SM a launch. The TPU kernel's +-1
// bit unpacking and MXU matmul are not carried over: they existed only to
// use the TPU's matrix unit.
#include "common.cuh"

namespace {

constexpr int kWarps = 24;                      // query rows in flight
constexpr int kThreads = kWarps * 32;
constexpr int kMaxTargets = 4096;               // the column's 12 bits
constexpr int kPerThread = (kMaxTargets + kThreads - 1) / kThreads;
constexpr int kMaxCells = 2048;                 // outer bins included
constexpr int kQueue = 64;                      // pending pairs a warp
constexpr unsigned kInR = 0x8000u;              // queue flag: inside r
constexpr float kFar = 1e6f;
constexpr unsigned kNone = 0xFFFFFFFFu;
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr float kBig = 1e9f;

struct Grid {
  float x0, y0, inv_s;
  int gx, gy;                                   // inner cells per axis
};

// Bin of a coordinate along one axis, non-decreasing in v: 0 below
// -kFar, 1 below the box, 2 .. g + 1 the inner cells, g + 2 from kFar
// up; -1 for NaN. Branch-free (the conversion saturates, and the selects
// override it outside the box).
__device__ __forceinline__ int axis_bin(float v, float o, float inv_s,
                                        int g) {
  int b = 2 + min(g - 1, __float2int_rz(__fmul_rn(__fsub_rn(v, o), inv_s)));
  b = v < o ? 1 : b;
  b = v < -kFar ? 0 : b;
  b = v >= kFar ? g + 2 : b;
  return v != v ? -1 : b;
}

// A float as an int that orders like it (for the integer warp
// reductions), and back.
__device__ __forceinline__ int order_key(float f) {
  const int k = __float_as_int(f);
  return k ^ ((k >> 31) & 0x7FFFFFFF);
}

__device__ __forceinline__ float from_key(int k) {
  return __int_as_float(k ^ ((k >> 31) & 0x7FFFFFFF));
}

__device__ __forceinline__ void push(unsigned key, unsigned& best,
                                     unsigned& second) {
  if (key < best) {
    second = best;
    best = key;
  } else if (key < second) {
    second = key;
  }
}

__device__ __forceinline__ void merge(unsigned& best, unsigned& second,
                                      unsigned ob, unsigned os) {
  const unsigned nb = min(best, ob);
  second = min(max(best, ob), min(second, os));
  best = nb;
}

__device__ __forceinline__ void write_gate(float* o, unsigned best,
                                           unsigned second) {
  o[0] = best == kNone ? kBig : static_cast<float>(best >> 12);
  o[1] = second == kNone ? kBig : static_cast<float>(second >> 12);
  o[2] = best == kNone ? 0.0f : static_cast<float>(best & 4095u);
}

// The Hamming distance of one queued pair (column | kInR) into the lane's
// running top-2.
__device__ __forceinline__ void take(unsigned e, const uint4* __restrict__ b4,
                                     uint4 q0, uint4 q1, unsigned& b1,
                                     unsigned& s1, unsigned& b2,
                                     unsigned& s2) {
  const unsigned col = e & 4095u;
  const uint4 w0 = __ldg(b4 + 2 * col);
  const uint4 w1 = __ldg(b4 + 2 * col + 1);
  const unsigned ham = __popc(q0.x ^ w0.x) + __popc(q0.y ^ w0.y) +
                       __popc(q0.z ^ w0.z) + __popc(q0.w ^ w0.w) +
                       __popc(q1.x ^ w1.x) + __popc(q1.y ^ w1.y) +
                       __popc(q1.z ^ w1.z) + __popc(q1.w ^ w1.w);
  const unsigned key = (ham << 12) | col;
  push(key, b2, s2);
  if (e & kInR) push(key, b1, s1);
}

// A query row's inputs, loaded a row ahead of their use.
struct Query {
  float u, v;
  uint4 q0, q1;
};

__device__ __forceinline__ Query load_query(const uint4* __restrict__ a4,
                                            const float* __restrict__ a_uv,
                                            int row, int m) {
  Query q{};
  if (row < m) {
    const float2 uv = reinterpret_cast<const float2*>(a_uv)[row];
    q.u = uv.x;
    q.v = uv.y;
    q.q0 = __ldg(a4 + 2 * row);
    q.q1 = __ldg(a4 + 2 * row + 1);
  }
  return q;
}

__global__ void __launch_bounds__(kThreads)
topk2_kernel(const uint4* __restrict__ a4, const float* __restrict__ a_uv,
             int m, const uint4* __restrict__ b4,
             const float* __restrict__ b_xy, int n, float r1sq, float r2sq,
             float reach, float* __restrict__ out) {
  // count[] is only used before the scatter fills sxy[]
  __shared__ union {
    int count[kMaxCells];
    float2 sxy[kMaxTargets];
  } sm;
  __shared__ uint16_t scol[kMaxTargets];
  __shared__ uint16_t start[kMaxCells + 1];
  __shared__ uint16_t queue[kWarps][kQueue];
  __shared__ int part[4][kWarps];
  __shared__ int wsum[kWarps];
  __shared__ Grid grid;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int stride = gridDim.x * kWarps;
  int row = blockIdx.x * kWarps + warp;
  // the first row's inputs load while the grid builds
  Query next = load_query(a4, a_uv, row, m);

  // ---- 1. the grid: bounding box of the keypoints within +-kFar
  float bx[kPerThread], by[kPerThread];
  float lo_x = INFINITY, hi_x = -INFINITY, lo_y = INFINITY, hi_y = -INFINITY;
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const int i = tid + k * kThreads;
    bx[k] = by[k] = NAN;
    if (i < n) {
      const float2 p = reinterpret_cast<const float2*>(b_xy)[i];
      bx[k] = p.x;
      by[k] = p.y;
      if (fabsf(p.x) < kFar && fabsf(p.y) < kFar) {
        lo_x = fminf(lo_x, p.x);
        hi_x = fmaxf(hi_x, p.x);
        lo_y = fminf(lo_y, p.y);
        hi_y = fmaxf(hi_y, p.y);
      }
    }
  }
  for (int i = tid; i < kMaxCells; i += kThreads) sm.count[i] = 0;
  int kx0 = __reduce_min_sync(kFull, order_key(lo_x));
  int kx1 = __reduce_max_sync(kFull, order_key(hi_x));
  int ky0 = __reduce_min_sync(kFull, order_key(lo_y));
  int ky1 = __reduce_max_sync(kFull, order_key(hi_y));
  if (lane == 0) {
    part[0][warp] = kx0;
    part[1][warp] = kx1;
    part[2][warp] = ky0;
    part[3][warp] = ky1;
  }
  __syncthreads();
  if (warp == 0) {
    const bool has = lane < kWarps;
    kx0 = __reduce_min_sync(kFull, has ? part[0][lane] : 0x7FFFFFFF);
    kx1 = __reduce_max_sync(kFull, has ? part[1][lane] : -0x7FFFFFFF - 1);
    ky0 = __reduce_min_sync(kFull, has ? part[2][lane] : 0x7FFFFFFF);
    ky1 = __reduce_max_sync(kFull, has ? part[3][lane] : -0x7FFFFFFF - 1);
    lo_x = from_key(kx0);
    hi_x = from_key(kx1);
    lo_y = from_key(ky0);
    hi_y = from_key(ky1);
    if (lane == 0) {
      if (!(lo_x <= hi_x)) lo_x = hi_x = lo_y = hi_y = 0.0f;  // none inside
      // cells of about r/2, grown until the grid fits kMaxCells
      float s = fmaxf(0.5f * sqrtf(r1sq), 1.0f);
      if (!(s < kFar)) s = kFar;                             // NaN, huge r
      int gx, gy;
      for (;;) {
        gx = __float2int_rz((hi_x - lo_x) / s) + 1;
        gy = __float2int_rz((hi_y - lo_y) / s) + 1;
        if (static_cast<long long>(gx + 3) * (gy + 3) <= kMaxCells) break;
        s *= 1.25f;
      }
      grid = Grid{lo_x, lo_y, 1.0f / s, gx, gy};
    }
  }
  __syncthreads();
  const Grid g = grid;
  const int GX = g.gx + 3, ncell = GX * (g.gy + 3);

  // ---- count per cell; rank within the cell
  int cell[kPerThread], rank[kPerThread];
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const int cx = axis_bin(bx[k], g.x0, g.inv_s, g.gx);
    const int cy = axis_bin(by[k], g.y0, g.inv_s, g.gy);
    cell[k] = (cx < 0 || cy < 0) ? -1 : cy * GX + cx;   // NaN or i >= n
    rank[k] = cell[k] < 0 ? 0 : atomicAdd(&sm.count[cell[k]], 1);
  }
  __syncthreads();

  // ---- exclusive prefix sum of the counts into start[]
  {
    const int per = (ncell + kThreads - 1) / kThreads;
    const int base = tid * per;
    int local = 0;
    for (int j = 0; j < per; ++j)
      if (base + j < ncell) local += sm.count[base + j];
    int incl = local;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int t = __shfl_up_sync(kFull, incl, off);
      if (lane >= off) incl += t;
    }
    if (lane == 31) wsum[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      const int t = lane < kWarps ? wsum[lane] : 0;
      int ti = t;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int u = __shfl_up_sync(kFull, ti, off);
        if (lane >= off) ti += u;
      }
      if (lane < kWarps) wsum[lane] = ti - t;
    }
    __syncthreads();
    int run = wsum[warp] + incl - local;
    for (int j = 0; j < per; ++j) {
      if (base + j < ncell) {
        start[base + j] = static_cast<uint16_t>(run);
        run += sm.count[base + j];
      }
    }
    if (base < ncell && base + per >= ncell)
      start[ncell] = static_cast<uint16_t>(run);
  }
  __syncthreads();

  // ---- scatter into cell order (overwrites count[])
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    if (cell[k] >= 0) {
      const int pos = start[cell[k]] + rank[k];
      sm.sxy[pos] = make_float2(bx[k], by[k]);
      scol[pos] = static_cast<uint16_t>(tid + k * kThreads);
    }
  }
  __syncthreads();

  // ---- 2-3. one warp per query row
  uint16_t* q = queue[warp];
  const unsigned below = (1u << lane) - 1u;
  for (; row < m; row += stride) {
    const Query cur = next;
    next = load_query(a4, a_uv, row + stride, m);
    const float u = cur.u, v = cur.v;
    int cx0 = 0, cx1 = g.gx + 2, cy0 = 0, cy1 = g.gy + 2;   // every bin
    if (reach < INFINITY) {
      cx0 = axis_bin(__fsub_rn(u, reach), g.x0, g.inv_s, g.gx);
      cx1 = axis_bin(__fadd_rn(u, reach), g.x0, g.inv_s, g.gx);
      cy0 = axis_bin(__fsub_rn(v, reach), g.y0, g.inv_s, g.gy);
      cy1 = axis_bin(__fadd_rn(v, reach), g.y0, g.inv_s, g.gy);
    }
    unsigned b1 = kNone, s1 = kNone, b2 = kNone, s2 = kNone;
    if (cx0 >= 0 && cx1 >= 0 && cy0 >= 0 && cy1 >= 0) {
      int head = 0, tail = 0;
      for (int cy = cy0; cy <= cy1; ++cy) {
        const int p1 = start[cy * GX + cx1 + 1];
        for (int p0 = start[cy * GX + cx0]; p0 < p1; p0 += 32) {
          const int p = p0 + lane;
          bool in2 = false, in1 = false;
          if (p < p1) {
            const float2 b = sm.sxy[p];
            const float du = __fsub_rn(u, b.x);
            const float dv = __fsub_rn(v, b.y);
            const float d2 = __fadd_rn(__fmul_rn(du, du), __fmul_rn(dv, dv));
            in2 = d2 <= r2sq;
            in1 = d2 <= r1sq;
          }
          const unsigned pass = __ballot_sync(kFull, in2);
          if (pass == 0u) continue;
          if (in2)
            q[(tail + __popc(pass & below)) & (kQueue - 1)] =
                static_cast<uint16_t>(scol[p] | (in1 ? kInR : 0u));
          tail += __popc(pass);
          if (tail - head >= 32) {
            __syncwarp();
            take(q[(head + lane) & (kQueue - 1)], b4, cur.q0, cur.q1, b1, s1,
                 b2, s2);
            head += 32;
            __syncwarp();
          }
        }
      }
      __syncwarp();
      if (lane < tail - head)
        take(q[(head + lane) & (kQueue - 1)], b4, cur.q0, cur.q1, b1, s1, b2,
             s2);
      __syncwarp();
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      merge(b1, s1, __shfl_down_sync(kFull, b1, off),
            __shfl_down_sync(kFull, s1, off));
      merge(b2, s2, __shfl_down_sync(kFull, b2, off),
            __shfl_down_sync(kFull, s2, off));
    }
    if (lane == 0) {
      float* o = out + static_cast<size_t>(row) * 8;
      write_gate(o, b1, s1);
      write_gate(o + 3, b2, s2);
      o[6] = 0.0f;
      o[7] = 0.0f;
    }
  }
}

}  // namespace

SLAM_API int slam_topk2_match(const uint32_t* a_desc, const float* a_uv,
                              int m, const uint32_t* b_desc,
                              const float* b_xy, int n, float r1sq,
                              float r2sq, float* out, cudaStream_t stream) {
  if (n < 0 || n > kMaxTargets) return static_cast<int>(cudaErrorInvalidValue);
  // the SM count, once per device (a CUDA graph capture may only launch)
  static int sms[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (sms[dev] == 0) {
    err = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount,
                                 dev);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (m > 0) {
    const int rows = (m + kWarps - 1) / kWarps;
    const int blocks = rows < sms[dev] ? rows : sms[dev];
    // |du| >= reach (or |dv| >= reach) fails the 2r gate after rounding;
    // an infinite or NaN reach makes every row scan every bin
    const float reach = sqrtf(r2sq) + 1.0f;
    topk2_kernel<<<blocks, kThreads, 0, stream>>>(
        reinterpret_cast<const uint4*>(a_desc), a_uv, m,
        reinterpret_cast<const uint4*>(b_desc), b_xy, n, r1sq, r2sq, reach,
        out);
  }
  return static_cast<int>(cudaGetLastError());
}
