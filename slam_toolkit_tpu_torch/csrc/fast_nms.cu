// FAST-9/16 + 3x3 NMS + high-threshold boost + border mask of every
// pyramid level of a frame in one launch.
//
// Replaces slam_toolkit_tpu/ops/fast_kernel.py::_fast_nms_pallas (the
// pl.pallas_call at fast_kernel.py:149): per level, the FAST response at
// one or two thresholds (the sum of the excess beyond the threshold on a
// bright or dark arc of >= 9 contiguous circle pixels), 3x3 non-max
// suppression per threshold with the row-major "earlier neighbour wins"
// tie-break, +1e4 for pixels that also survive at the high threshold,
// and the border mask. Bit-exact against the plain fast.detect_dual /
// fast.detect: the sums are additions in the fixed CIRCLE_OFFSETS order
// with no multiplies (nothing to contract into an FMA), and the image is
// read with clamped coordinates, which is the plain version's edge
// padding, so the result is exact at every border (the TPU kernel's zero
// halo was exact only from border 5). Outside the image the NMS sees -1,
// as nms3x3 pads.
//
// What bounds it on an H100, by the count chip_smoke.py makes on a
// rendered frame at both thresholds: operations (~3.4 us) a little
// above bytes (~3.2 us: a frame's 8 levels hold ~1.5M pixels, each
// written once, and the ~1.4M within 4 of the valid interior read
// once). A (pixel, threshold, side) that passes the cardinal test costs
// 50 float32 and 28 integer operations (about 1.5 of them a passing
// pixel); on the card the per-tile bookkeeping around them (staging,
// the cardinal tests, the queues, the zero writes) takes more of the
// kernel's time than the responses do.
//
// Design: the levels travel as pointers with their shapes and first
// blocks in one by-value struct (at most kMaxLevels), so a frame is one
// launch; a block finds its level in the struct, which stays in
// parameter space (__grid_constant__). A block of 4 warps owns a 30 x 14
// output tile: it stages the 38 x 22 image tile (3 for the circle, 1 for
// NMS) and its negation in shared memory by rows, every load in flight
// at once, and tests the 32 x 16 response tile one row of 32 lanes at a
// time. Only the responses a valid output needs are computed (the
// border's ring and beyond are skipped; a tile wholly in the border
// writes zeros), and only where an exact test passes: a 9-arc beyond a
// threshold covers two neighbouring cardinal taps (0 and 4, 4 and 8, 8
// and 12, or 12 and 0) beyond it, so a (pixel, threshold, side) without
// such a pair has response 0.0f there. The triples that pass (from about
// half the pixels of a rendered frame) go into a queue in shared memory,
// and the block's threads take them from it, so no lane idles on one
// that failed. Each is one pass over the 16 taps of the image tile, or
// of its negation for a dark arc (one load, two differences, a mask bit
// that is the sign of a difference, funnel-shifted in, and the excess
// summed in tap order) and one arc test of 4 log-step shift-ands; the
// larger side's sum is kept with a shared-memory max. Each thread then
// writes zeros for its output pixels that are masked or whose centre is
// <= 0 at both thresholds (no NMS keeps them), and the positive centres
// go through a second queue to the threads that suppress them from the
// shared response tiles.
#include "common.cuh"

namespace {

constexpr int kMaxLevels = 16;
constexpr int kRW = 32;                 // response tile: a warp's row
constexpr int kRH = 16;
constexpr int kOW = kRW - 2;            // output tile (1-pixel NMS ring)
constexpr int kOH = kRH - 2;
constexpr int kIW = kRW + 6;            // image tile (3-pixel circle)
constexpr int kIH = kRH + 6;
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kDark = 1, kHigh = 2, kSides = 4;   // candidate kinds
static_assert(kRH % kWarps == 0, "whole response rows a warp");

struct Levels {
  const float* img[kMaxLevels];
  float* out[kMaxLevels];
  int h[kMaxLevels];
  int w[kMaxLevels];
  int tiles_x[kMaxLevels];
  int first[kMaxLevels + 1];   // level i's blocks: first[i], first[i + 1])
  int count;
};

// CIRCLE_OFFSETS[k] + 3 as nibble k, so that the unrolled taps are
// compile-time offsets.
__host__ __device__ constexpr int tap_dy(int k) {
  return static_cast<int>((0x0123456665432100ULL >> (4 * k)) & 0xFu) - 3;
}
__host__ __device__ constexpr int tap_dx(int k) {
  return static_cast<int>((0x2100012345666543ULL >> (4 * k)) & 0xFu) - 3;
}

// >= 9 consecutive circle bits set, with wraparound.
__device__ __forceinline__ bool arc(unsigned m) {
  const unsigned m2 = m | (m << 16);
  unsigned r = m2 & (m2 >> 1);          // runs of 2 from each bit
  r &= r >> 2;                          // 4
  r &= r >> 4;                          // 8
  r &= m2 >> 8;                         // 9
  return (r & 0xFFFFu) != 0u;
}

// The response on one side at one threshold (+0 when zero) at image tile
// position (y, x): a bright arc of t, or a dark one when t holds the
// negated image, since -(v - c) is (-v) - (-c) bit for bit. The sign of
// thr - d is d > thr (an exact zero is +0, and a NaN comes out of the
// subtraction as the positive canonical NaN, so the bit is 0 where the
// compare is false); a funnel shift moves it into the mask, so the mask
// holds the taps in reverse order, which leaves its cyclic runs as they
// are. -(thr - d) is d - thr bit for bit, and x + fmaxf(e, 0) adds
// exactly what `if (e > 0) x = x + e` adds (the sum starts at +0 and
// stays non-negative); nothing is a multiply, so nothing contracts.
__device__ __forceinline__ float side_response(const float (*t)[kIW], int y,
                                               int x, float thr) {
  const float c = t[y][x];
  unsigned m = 0u;
  float sum = 0.0f;
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    const float u = thr - (t[y + tap_dy(k)][x + tap_dx(k)] - c);
    m = __funnelshift_l(__float_as_uint(u), m, 1);
    sum = sum + fmaxf(-u, 0.0f);
  }
  return arc(m) ? sum : 0.0f;
}

// Which (threshold, side) pairs can have an arc: a 9-arc covers two
// neighbouring cardinal taps (0 and 4, 4 and 8, 8 and 12, or 12 and 0),
// each of them one of taps 0 and 8 with one of taps 4 and 12, so a side
// is a candidate at thr where one of each lies beyond thr. d0..d12 are
// the differences of taps 0, 4, 8 and 12; fmaxf and fminf drop a NaN,
// which no compare finds beyond thr.
__device__ __forceinline__ void cardinal(float d0, float d4, float d8,
                                         float d12, float thr_lo,
                                         float thr_hi, bool dual,
                                         bool (&cand)[kSides]) {
  const float hi08 = fmaxf(d0, d8), hi412 = fmaxf(d4, d12);
  const float lo08 = fminf(d0, d8), lo412 = fminf(d4, d12);
  cand[0] = hi08 > thr_lo && hi412 > thr_lo;
  cand[kDark] = lo08 < -thr_lo && lo412 < -thr_lo;
  cand[kHigh] = dual && hi08 > thr_hi && hi412 > thr_hi;
  cand[kHigh | kDark] = dual && lo08 < -thr_hi && lo412 < -thr_hi;
}

// fast.nms3x3 at response tile position (ry, rx): a positive maximum
// above the 4 row-major earlier neighbours and not below the 4 later.
__device__ __forceinline__ float nms(const float (*r)[kRW], int ry, int rx) {
  const float s = r[ry][rx];
  const float before = fmaxf(fmaxf(r[ry - 1][rx - 1], r[ry - 1][rx]),
                             fmaxf(r[ry - 1][rx + 1], r[ry][rx - 1]));
  const float after = fmaxf(fmaxf(r[ry][rx + 1], r[ry + 1][rx - 1]),
                            fmaxf(r[ry + 1][rx], r[ry + 1][rx + 1]));
  return (s > 0.0f && s > before && s >= after) ? s : 0.0f;
}

template <bool kDual>
__global__ void __launch_bounds__(kThreads)
fast_nms_kernel(const __grid_constant__ Levels lv, float thr_hi, float thr_lo,
                int border) {
  __shared__ float img[2][kIH][kIW];     // the image tile and its negation
  __shared__ float rlo[kRH][kRW];
  __shared__ float rhi[kDual ? kRH : 1][kRW];
  // (response tile index, threshold, side) candidates, then positive
  // centres' output index
  __shared__ unsigned short queue[kSides * kRH * kRW];
  __shared__ int queued, positive;
  // the block's level: the struct stays in parameter space
  int l = 0;
  while (l + 1 < lv.count && static_cast<int>(blockIdx.x) >= lv.first[l + 1])
    ++l;
  const float* src = lv.img[l];
  float* dst = lv.out[l];
  const int h = lv.h[l], w = lv.w[l], tiles_x = lv.tiles_x[l];
  const int first = lv.first[l];
  const int tile = blockIdx.x - first;
  const int y0 = (tile / tiles_x) * kOH, x0 = (tile % tiles_x) * kOW;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // valid outputs: [border, h - border) x [border, w - border)
  const int vy0 = border, vy1 = h - border, vx0 = border, vx1 = w - border;
  if (vy1 <= vy0 || vx1 <= vx0 || y0 >= vy1 || y0 + kOH <= vy0 ||
      x0 >= vx1 || x0 + kOW <= vx0) {
    for (int oy = warp; oy < kOH; oy += kWarps) {
      const int y = y0 + oy, x = x0 + lane;
      if (lane < kOW && y < h && x < w)
        dst[static_cast<size_t>(y) * w + x] = 0.0f;
    }
    return;
  }

  if (threadIdx.x == 0) queued = positive = 0;
  {  // the image tile by rows, every load in flight before the first store
    constexpr int kRows = (kIH + kWarps - 1) / kWarps;
    const int gx0 = slam::clampi(x0 - 4 + lane, 0, w - 1);
    const int gx1 = slam::clampi(x0 - 4 + 32 + lane, 0, w - 1);
    float v[kRows][2];
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      const int iy = warp + j * kWarps;
      const float* row = src + static_cast<size_t>(
          slam::clampi(y0 - 4 + iy, 0, h - 1)) * w;
      if (iy < kIH) {
        v[j][0] = __ldg(row + gx0);
        if (32 + lane < kIW) v[j][1] = __ldg(row + gx1);
      }
    }
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      const int iy = warp + j * kWarps;
      if (iy < kIH) {
        img[0][iy][lane] = v[j][0];
        img[1][iy][lane] = -v[j][0];
        if (32 + lane < kIW) {
          img[0][iy][32 + lane] = v[j][1];
          img[1][iy][32 + lane] = -v[j][1];
        }
      }
    }
  }
  __syncthreads();

  // response tile (ry, rx) is pixel (y0 - 1 + ry, x0 - 1 + rx), image
  // tile (ry + 3, rx + 3); a valid output's 3x3 needs the responses of
  // [vy0 - 1, vy1] x [vx0 - 1, vx1]. Pass 1: -1 outside the image, 0
  // elsewhere; the (pixel, threshold, side) candidates are queued.
  constexpr int kRowsPerWarp = kRH / kWarps;
  const int gx = x0 - 1 + lane;           // this lane's response column
  const bool col_in = gx >= 0 && gx < w;
  const bool col_need = col_in && gx >= vx0 - 1 && gx <= vx1;
  unsigned ballot[kRowsPerWarp][kSides];
  int total = 0;
#pragma unroll
  for (int j = 0; j < kRowsPerWarp; ++j) {
    const int ry = warp + j * kWarps;
    const int gy = y0 - 1 + ry;
    const bool inside = col_in && gy >= 0 && gy < h;
    bool cand[kSides] = {};
    if (col_need && gy >= vy0 - 1 && gy <= vy1 && gy >= 0 && gy < h) {
      const float (*t)[kIW] = img[0];
      const float c = t[ry + 3][lane + 3];
      cardinal(t[ry][lane + 3] - c, t[ry + 3][lane + 6] - c,
               t[ry + 6][lane + 3] - c, t[ry + 3][lane] - c, thr_lo, thr_hi,
               kDual, cand);
    }
    rlo[ry][lane] = inside ? 0.0f : -1.0f;
    if (kDual) rhi[ry][lane] = inside ? 0.0f : -1.0f;
#pragma unroll
    for (int k = 0; k < kSides; ++k) {
      ballot[j][k] = __ballot_sync(0xFFFFFFFFu, cand[k]);
      total += __popc(ballot[j][k]);
    }
  }
  // one queue slot range a warp
  int base = 0;
  if (lane == 0 && total) base = atomicAdd(&queued, total);
  base = __shfl_sync(0xFFFFFFFFu, base, 0);
  const unsigned below = (1u << lane) - 1u;
#pragma unroll
  for (int j = 0; j < kRowsPerWarp; ++j) {
#pragma unroll
    for (int k = 0; k < kSides; ++k) {
      if (ballot[j][k] >> lane & 1u)
        queue[base + __popc(ballot[j][k] & below)] =
            static_cast<unsigned short>(k * kRH * kRW +
                                        (warp + j * kWarps) * kRW + lane);
      base += __popc(ballot[j][k]);
    }
  }
  __syncthreads();
  // pass 2: one side's response at one threshold a candidate, every lane
  // busy; a pixel's response is the larger side's (a max, exact, on the
  // non-negative floats' bit patterns)
  thr_lo = thr_lo + 0.0f;               // -0 -> +0 for the sign-bit masks
  thr_hi = thr_hi + 0.0f;
  for (int q = threadIdx.x; q < queued; q += kThreads) {
    const int e = queue[q], side = e / (kRH * kRW), i = e % (kRH * kRW);
    const int ry = i / kRW, rx = i % kRW;
    const bool at_hi = side & kHigh;
    const float r = side_response(img[side & kDark ? 1 : 0], ry + 3, rx + 3,
                                  at_hi ? thr_hi : thr_lo);
    if (r > 0.0f) {
      float* slot = kDual && at_hi ? &rhi[ry][rx] : &rlo[ry][rx];
      atomicMax(reinterpret_cast<int*>(slot), __float_as_int(r));
    }
  }
  __syncthreads();

  // Output rows: zeros where the centre is masked or <= 0 at both
  // thresholds (no NMS keeps it); the positive centres are queued, and
  // the block's threads take their NMS from the queue.
  int n_pos = 0;
  unsigned pos_ballot[(kOH + kWarps - 1) / kWarps];
#pragma unroll
  for (int j = 0; j * kWarps < kOH; ++j) {
    const int oy = warp + j * kWarps;
    const int y = y0 + oy, x = x0 + lane;
    const bool out = oy < kOH && lane < kOW && y < h && x < w;
    const bool pos = out && y >= vy0 && y < vy1 && x >= vx0 && x < vx1 &&
                     (rlo[oy + 1][lane + 1] > 0.0f ||
                      (kDual && rhi[oy + 1][lane + 1] > 0.0f));
    if (out && !pos) dst[static_cast<size_t>(y) * w + x] = 0.0f;
    pos_ballot[j] = __ballot_sync(0xFFFFFFFFu, pos);
    n_pos += __popc(pos_ballot[j]);
  }
  int pbase = 0;
  if (lane == 0 && n_pos) pbase = atomicAdd(&positive, n_pos);
  pbase = __shfl_sync(0xFFFFFFFFu, pbase, 0);
#pragma unroll
  for (int j = 0; j * kWarps < kOH; ++j) {
    if (pos_ballot[j] >> lane & 1u)
      queue[pbase + __popc(pos_ballot[j] & ((1u << lane) - 1u))] =
          static_cast<unsigned short>((warp + j * kWarps) * kRW + lane);
    pbase += __popc(pos_ballot[j]);
  }
  __syncthreads();
  for (int q = threadIdx.x; q < positive; q += kThreads) {
    const int oy = queue[q] / kRW, ox = queue[q] % kRW;
    float eff = nms(rlo, oy + 1, ox + 1);
    if (kDual && nms(rhi, oy + 1, ox + 1) > 0.0f) eff = eff + 1e4f;
    dst[static_cast<size_t>(y0 + oy) * w + x0 + ox] = eff;
  }
}

}  // namespace

// n_levels images imgs[i] of hs[i] x ws[i] -> outs[i] of the same shape,
// in one launch. dual = 0 is the single-threshold detector (thr_lo).
// Refuses more than kMaxLevels levels and empty images.
SLAM_API int slam_fast_nms_levels(const float* const* imgs,
                                  float* const* outs, const int* hs,
                                  const int* ws, int n_levels, int dual,
                                  float thr_hi, float thr_lo, int border,
                                  cudaStream_t stream) {
  if (n_levels < 1 || n_levels > kMaxLevels)
    return static_cast<int>(cudaErrorInvalidValue);
  Levels lv{};
  long long blocks = 0;
  for (int i = 0; i < n_levels; ++i) {
    if (hs[i] < 1 || ws[i] < 1)
      return static_cast<int>(cudaErrorInvalidValue);
    lv.img[i] = imgs[i];
    lv.out[i] = outs[i];
    lv.h[i] = hs[i];
    lv.w[i] = ws[i];
    lv.tiles_x[i] = (ws[i] + kOW - 1) / kOW;
    lv.first[i] = static_cast<int>(blocks);
    blocks += static_cast<long long>(lv.tiles_x[i]) *
              ((hs[i] + kOH - 1) / kOH);
    if (blocks > 0x7FFFFFFF) return static_cast<int>(cudaErrorInvalidValue);
  }
  lv.first[n_levels] = static_cast<int>(blocks);
  lv.count = n_levels;
  const dim3 grid(static_cast<unsigned>(blocks)), block(kThreads);
  if (dual) {
    fast_nms_kernel<true><<<grid, block, 0, stream>>>(lv, thr_hi, thr_lo,
                                                      border);
  } else {
    fast_nms_kernel<false><<<grid, block, 0, stream>>>(lv, thr_hi, thr_lo,
                                                       border);
  }
  return static_cast<int>(cudaGetLastError());
}
