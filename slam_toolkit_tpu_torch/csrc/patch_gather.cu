// Patch gather: windows of (bh, bw) from one or several float32 images.
//
// Replaces slam_toolkit_tpu/ops/patches.py::_gather_blocks_pallas (the
// pl.pallas_call at patches.py:113). On the main path it gathers the
// 31x31 BRIEF patches of every pyramid level of a frame, ~2000 windows
// over 8 images, in one launch.
//
// What bounds it on an H100: bytes and, at this size, the launch. It
// copies K * bh * bw floats (2000 windows of 31x31: 7.7 MB written, the
// 32-byte sectors of the images that the windows cover read) and computes
// nothing. One launch per pyramid level costs ~3.4 us whatever its size
// (launch, ramp-up and tail), more than the frame's bytes take.
//
// Design: the images are passed by pointer, with their heights, widths
// and window offsets, in one by-value struct (at most kMaxImages), so all
// the levels of a frame are gathered in one launch without copying them
// into one buffer. One warp copies kRows = 8 rows of one window: lane c
// copies column c of each (31 of 32 lanes on 124 contiguous bytes of a
// row, read and written), the 8 loads in flight before their stores, so
// a frame's ~8000 (window, row group) tasks are each one round trip to
// L2 and all fit on the card at once. One integer divide per task, none
// per element. The image of a window is found by comparing its index
// with the offsets once per task. The TPU kernel's aligned super-window
// loads and two rolls existed only for the
// TPU's (8, 128) vector tiling and are not carried over. Corners are
// clamped into their image exactly like lax.dynamic_slice, so the copy
// is exact.
#include "common.cuh"

namespace {

constexpr int kMaxImages = 16;
constexpr int kWarps = 8;                 // tasks in flight per block
constexpr int kRows = 8;                  // rows loaded before stored

struct Images {
  const float* img[kMaxImages];
  int h[kMaxImages];
  int w[kMaxImages];
  int first[kMaxImages + 1];   // image i's windows: first[i], first[i + 1])
  int count;
};

__global__ void __launch_bounds__(kWarps * 32)
gather_blocks_kernel(const Images im, const int* __restrict__ ys,
                     const int* __restrict__ xs, int bh, int bw,
                     float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int groups = (bh + kRows - 1) / kRows;       // row groups a window
  const int tasks = im.first[im.count] * groups;
  for (int t = blockIdx.x * kWarps + (threadIdx.x >> 5); t < tasks;
       t += gridDim.x * kWarps) {
    const int win = t / groups;
    const int r0 = (t - win * groups) * kRows;
    // the window's image, with static indices into the parameter struct
    const float* img = im.img[0];
    int h = im.h[0], w = im.w[0];
#pragma unroll
    for (int i = 1; i < kMaxImages; ++i) {
      if (i < im.count && win >= im.first[i]) {
        img = im.img[i];
        h = im.h[i];
        w = im.w[i];
      }
    }
    const int y0 = slam::clampi(__ldg(ys + win), 0, h - bh);
    const int x0 = slam::clampi(__ldg(xs + win), 0, w - bw);
    const float* __restrict__ src = img + static_cast<size_t>(y0) * w + x0;
    float* __restrict__ dst = out + static_cast<size_t>(win) * bh * bw;
    for (int c = lane; c < bw; c += 32) {
      float v[kRows];
#pragma unroll
      for (int k = 0; k < kRows; ++k)
        if (r0 + k < bh)
          v[k] = __ldg(src + static_cast<size_t>(r0 + k) * w + c);
#pragma unroll
      for (int k = 0; k < kRows; ++k)
        if (r0 + k < bh) dst[(r0 + k) * bw + c] = v[k];
    }
  }
}

}  // namespace

// n_images images imgs[i] of hs[i] x ws[i]; windows first[i] ..
// first[i + 1] - 1 (first[0] = 0) are cut from image i at corners
// (ys[k], xs[k]), into out (first[n_images], bh, bw). Refuses more than
// kMaxImages images and windows larger than an image they are cut from.
SLAM_API int slam_gather_blocks(const float* const* imgs, const int* hs,
                                const int* ws, const int* first,
                                int n_images, const int* ys, const int* xs,
                                int bh, int bw, float* out,
                                cudaStream_t stream) {
  if (n_images < 1 || n_images > kMaxImages || bh < 1 || bw < 1 ||
      first[0] != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Images im{};
  for (int i = 0; i < n_images; ++i) {
    if (first[i + 1] < first[i] ||
        (first[i + 1] > first[i] && (hs[i] < bh || ws[i] < bw)))
      return static_cast<int>(cudaErrorInvalidValue);
    im.img[i] = imgs[i];
    im.h[i] = hs[i];
    im.w[i] = ws[i];
    im.first[i] = first[i];
  }
  im.first[n_images] = first[n_images];
  im.count = n_images;
  const long long tasks =
      static_cast<long long>(first[n_images]) * ((bh + kRows - 1) / kRows);
  if (tasks > 0x7FFFFFFF) return static_cast<int>(cudaErrorInvalidValue);
  if (tasks > 0) {
    const int blocks = static_cast<int>((tasks + kWarps - 1) / kWarps);
    gather_blocks_kernel<<<blocks, kWarps * 32, 0, stream>>>(im, ys, xs, bh,
                                                             bw, out);
  }
  return static_cast<int>(cudaGetLastError());
}
