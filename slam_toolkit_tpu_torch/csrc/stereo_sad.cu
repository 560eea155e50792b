// Stereo SAD cost curves: 11x11 window of each left keypoint against the
// rectified right-row strip, over NS = max_disp + 3 shifts.
//
// Replaces slam_toolkit_tpu/ops/stereo_sad.py::_curve_pallas (the
// pl.pallas_call at stereo_sad.py:128). On the main path it runs on
// keyframes for K = 2048 keypoints at max_disp = 100 (NS = 103, strip
// width 113). Argmin, parabola and uniqueness stay in PyTorch
// (ops/stereo_sad.py), as in the JAX package.
//
// What bounds it on an H100: by the count chip_smoke.py makes, bytes:
// the 32-byte sectors that the K = 2048 left windows (~1.1 MB) and right
// strips (~1.8 MB) cover, read once, and the 0.8 MB of curves written,
// ~1.1 us at 3.35 TB/s; its 121 subtracts and 121 adds per output (the
// absolute value is an operand modifier of the add; 51M at K = 2048)
// take ~0.76 us at the float32 peak. What limits
// the kernel itself is issuing those operations and the shared-memory
// loads that feed them: one load per difference, as a thread per shift
// did, costs more than the arithmetic.
//
// Design: one warp per keypoint, kWarps keypoints a block. The warp
// stages its 11x11 patch (rows padded to 12) and 144 strip columns of
// each window row in shared memory, all its loads in flight at once.
// Lane l owns the 4 consecutive shifts 4l .. 4l+3 of a group of 128:
// per window row it loads the 12 patch values (3 broadcast float4) and
// the 16 strip values it needs (4 float4) into registers, then updates
// its 4 row sums, ~7 loads for 44 differences. NS above 128 loops over
// groups. Each sum keeps the
// order of the JAX package's _sad_from_blocks: along a window row
// (columns 0..10), then over the rows 0..10. Corners are clamped into
// the image like lax.dynamic_slice.
//
// The batched entry takes B problems of the same size (B lanes' image
// pairs and corners, the JAX package's vmapped _curve_pallas): lane b is
// blockIdx.y, whose pointers are offset to its b-th problem before the
// single launch's body runs, so each lane's curves are its single
// launch's. A lane whose entry of the int32 mask `lanes` is 0 writes
// nothing: its blocks return at once.
#include "common.cuh"

namespace {

constexpr int kWin = 5;                 // half window
constexpr int kSide = 2 * kWin + 1;     // 11
constexpr int kPad = 1;                 // parabola neighbours past the range
constexpr int kWarps = 4;               // keypoints a block
constexpr int kPer = 4;                 // shifts a lane
constexpr int kGroup = 32 * kPer;       // shifts a warp pass
constexpr int kSegW = kGroup + 16;      // strip columns a pass stages
constexpr int kPatchW = 12;             // patch row padded to 3 float4

__device__ __forceinline__ void unpack(float4 t, float* d) {
  d[0] = t.x;
  d[1] = t.y;
  d[2] = t.z;
  d[3] = t.w;
}

__global__ void __launch_bounds__(kWarps * 32)
sad_curve_kernel(const float* __restrict__ img_l,
                 const float* __restrict__ img_r, int h, int w,
                 const int* __restrict__ ys0, const int* __restrict__ xl0,
                 const int* __restrict__ xs0, int k, int max_disp,
                 const int* __restrict__ lanes, float* __restrict__ out) {
  if (lanes != nullptr && __ldg(lanes + blockIdx.y) == 0) return;
  {
    // this block's problem of a batched launch (0 for a single one)
    const size_t p = blockIdx.y;
    img_l += p * h * w;
    img_r += p * h * w;
    ys0 += p * k;
    xl0 += p * k;
    xs0 += p * k;
    out += p * k * (max_disp + 2 * kPad + 1);
  }
  __shared__ __align__(16) float patch_s[kWarps][kSide][kPatchW];
  __shared__ __align__(16) float strip_s[kWarps][kSide][kSegW];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int kp = blockIdx.x * kWarps + warp;
  if (kp >= k) return;                  // warps synchronise only alone
  const int sw = kSide + max_disp + 2 * kPad;
  const int ns = max_disp + 2 * kPad + 1;
  const int y = slam::clampi(__ldg(ys0 + kp), 0, h - kSide);
  const int xl = slam::clampi(__ldg(xl0 + kp), 0, w - kSide);
  const int xs = slam::clampi(__ldg(xs0 + kp), 0, w - sw);
  float(*patch)[kPatchW] = patch_s[warp];
  float(*strip)[kSegW] = strip_s[warp];
  {  // every load in flight before the first store
    constexpr int kSlots = (kSide * kPatchW + 31) / 32;
    float v[kSlots];
#pragma unroll
    for (int j = 0; j < kSlots; ++j) {
      const int i = lane + 32 * j, r = i / kPatchW, c = i - r * kPatchW;
      v[j] = i < kSide * kPatchW && c < kSide
          ? __ldg(img_l + static_cast<size_t>(y + r) * w + xl + c) : 0.0f;
    }
#pragma unroll
    for (int j = 0; j < kSlots; ++j) {
      const int i = lane + 32 * j;
      if (i < kSide * kPatchW) patch[i / kPatchW][i % kPatchW] = v[j];
    }
  }
  for (int g = 0; g < ns; g += kGroup) {
    constexpr int kSlots = (kSegW + 31) / 32;
    const int cols = min(kSegW, sw - g);
    float v[kSide][kSlots];
#pragma unroll
    for (int r = 0; r < kSide; ++r) {
      const float* src = img_r + static_cast<size_t>(y + r) * w + xs + g;
#pragma unroll
      for (int j = 0; j < kSlots; ++j) {
        const int c = lane + 32 * j;
        v[r][j] = c < cols ? __ldg(src + c) : 0.0f;
      }
    }
    __syncwarp();                       // the last group's reads are done
#pragma unroll
    for (int r = 0; r < kSide; ++r) {
#pragma unroll
      for (int j = 0; j < kSlots; ++j)
        if (lane + 32 * j < kSegW) strip[r][lane + 32 * j] = v[r][j];
    }
    __syncwarp();
    const int s0 = g + kPer * lane;
    if (s0 >= ns) continue;
    float total[kPer];
#pragma unroll
    for (int r = 0; r < kSide; ++r) {
      float p[kPatchW], v[16];
#pragma unroll
      for (int q = 0; q < kPatchW / 4; ++q)
        unpack(reinterpret_cast<const float4*>(patch[r])[q], p + 4 * q);
#pragma unroll
      for (int q = 0; q < 4; ++q)
        unpack(reinterpret_cast<const float4*>(strip[r] + kPer * lane)[q],
               v + 4 * q);
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        float row = fabsf(v[j] - p[0]);
#pragma unroll
        for (int c = 1; c < kSide; ++c) row += fabsf(v[j + c] - p[c]);
        total[j] = r == 0 ? row : total[j] + row;
      }
    }
    float* o = out + static_cast<size_t>(kp) * ns + s0;
#pragma unroll
    for (int j = 0; j < kPer; ++j)
      if (s0 + j < ns) o[j] = total[j];
  }
}

}  // namespace

// `problems` problems: img_l and img_r (problems, h, w), ys0, xl0 and
// xs0 (problems, k), out (problems, k, max_disp + 3); lanes (problems,)
// int32, 0 for a problem to skip, or null for none skipped.
SLAM_API int slam_sad_curve_batched(const float* img_l, const float* img_r,
                                    int h, int w, const int* ys0,
                                    const int* xl0, const int* xs0, int k,
                                    int max_disp, int problems,
                                    const int* lanes, float* out,
                                    cudaStream_t stream) {
  if (k < 0 || max_disp < 0 || problems < 1 || problems > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (k > 0) {
    const dim3 grid((k + kWarps - 1) / kWarps, problems);
    sad_curve_kernel<<<grid, kWarps * 32, 0, stream>>>(
        img_l, img_r, h, w, ys0, xl0, xs0, k, max_disp, lanes, out);
  }
  return static_cast<int>(cudaGetLastError());
}

SLAM_API int slam_sad_curve(const float* img_l, const float* img_r, int h,
                            int w, const int* ys0, const int* xl0,
                            const int* xs0, int k, int max_disp, float* out,
                            cudaStream_t stream) {
  return slam_sad_curve_batched(img_l, img_r, h, w, ys0, xl0, xs0, k,
                                max_disp, 1, nullptr, out, stream);
}
