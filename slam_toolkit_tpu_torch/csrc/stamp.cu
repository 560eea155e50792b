// The device clock for the program's tracer (utils/timing.stamp): one
// thread writes %globaltimer, the card's nanosecond clock, into one slot
// of an int64 buffer. Replaces no TPU kernel: the JAX chunk is one XLA
// program with no clock inside it. A stamp is a kernel node, which a
// CUDA graph's conditional bodies accept (an event-record node is not
// among the node types a conditional body may hold), so a chunk graph
// can stamp each frame inside its WHILE node and each keyframe event
// inside its IF node. The slot is base + (*row) * width, or base where
// row is null: `row` is a device index (the chunk's frame index), read
// when the kernel runs, so one captured node stamps every iteration's
// row. Bound by launch latency alone (8 bytes written).
#include "common.cuh"

namespace {

__global__ void stamp_kernel(long long* dst, const long long* row,
                             long long base, int width) {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  const long long at = row == nullptr ? base : base + (*row) * width;
  dst[at] = static_cast<long long>(t);
}

}  // namespace

SLAM_API int slam_stamp(long long* dst, const long long* row,
                        long long base, int width, cudaStream_t stream) {
  stamp_kernel<<<1, 1, 0, stream>>>(dst, row, base, width);
  return cudaGetLastError();
}
