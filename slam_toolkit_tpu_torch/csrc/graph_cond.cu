// CUDA-graph conditional nodes for a stream capture under way
// (utils/cuda_graphs run_if and run_while): the JAX programs' lax.cond
// and lax.scan (a while loop over a device frame index) on a device flag.
//
// slam_if_begin adds to the graph that `stream` is capturing a kernel
// that copies the one-byte flag into a conditional handle, then an IF
// conditional node after it, makes the node the stream's only capture
// dependency, and starts capturing `body` into the node's child graph
// (thread-local mode). The caller launches the body's work on `body` and
// ends it with slam_if_end. At a replay the node runs its body when the
// flag was set. slam_while_begin does the same with a WHILE node and
// hands back the node's handle; slam_while_end launches the same kernel
// on `body` as the body's last node (the flag's value after an
// iteration decides the next) before it ends the body's capture. The
// node runs its body for as long as the flag, read at its entry and
// after each iteration, is set. Nested bodies: `stream` may itself be a
// body stream. Conditional nodes need CUDA 12.4 or later, in the
// toolkit and on the card's installed stack; older toolkits get
// cudaErrorNotSupported. The body streams
// come from slam_stream_create (kept for the process): a stream of
// torch's pool may be the very stream that is capturing.
#include "common.cuh"

SLAM_API int slam_stream_create(cudaStream_t* out) {
  return cudaStreamCreateWithFlags(out, cudaStreamNonBlocking);
}

#if CUDART_VERSION >= 12040

namespace {

__global__ void set_condition(cudaGraphConditionalHandle handle,
                              const bool* flag) {
  cudaGraphSetConditional(handle, *flag ? 1u : 0u);
}

int capture_info(cudaStream_t s, cudaGraph_t* graph,
                 const cudaGraphNode_t** deps, size_t* n_deps) {
  cudaStreamCaptureStatus status;
  unsigned long long id;
  cudaError_t err = cudaStreamGetCaptureInfo(s, &status, &id, graph, deps,
                                             n_deps);
  if (err != cudaSuccess) return err;
  return status == cudaStreamCaptureStatusActive
             ? cudaSuccess
             : cudaErrorStreamCaptureImplicit;
}

// The flag's kernel on `stream`, then a conditional node of `type`
// after it as the stream's only dependency, and `body` capturing into
// the node's child graph.
int cond_begin(cudaGraphConditionalNodeType type, const bool* flag,
               cudaStream_t body, cudaStream_t stream,
               cudaGraphConditionalHandle* handle) {
  cudaGraph_t graph;
  const cudaGraphNode_t* deps;
  size_t n_deps;
  int err = capture_info(stream, &graph, &deps, &n_deps);
  if (err != cudaSuccess) return err;
  err = cudaGraphConditionalHandleCreate(handle, graph, 0, 0);
  if (err != cudaSuccess) return err;
  set_condition<<<1, 1, 0, stream>>>(*handle, flag);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = capture_info(stream, &graph, &deps, &n_deps);   // the set kernel
  if (err != cudaSuccess) return err;
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = *handle;
  params.conditional.type = type;
  params.conditional.size = 1;
  cudaGraphNode_t node;
  err = cudaGraphAddNode(&node, graph, deps, n_deps, &params);
  if (err != cudaSuccess) return err;
  err = cudaStreamUpdateCaptureDependencies(stream, &node, 1,
                                            cudaStreamSetCaptureDependencies);
  if (err != cudaSuccess) return err;
  return cudaStreamBeginCaptureToGraph(body, params.conditional.phGraph_out[0],
                                       nullptr, nullptr, 0,
                                       cudaStreamCaptureModeThreadLocal);
}

}  // namespace

SLAM_API int slam_if_begin(const bool* flag, cudaStream_t body,
                           cudaStream_t stream) {
  cudaGraphConditionalHandle handle;
  return cond_begin(cudaGraphCondTypeIf, flag, body, stream, &handle);
}

SLAM_API int slam_if_end(cudaStream_t body) {
  cudaGraph_t graph;
  return cudaStreamEndCapture(body, &graph);
}

SLAM_API int slam_while_begin(const bool* cond, cudaStream_t body,
                              cudaStream_t stream,
                              unsigned long long* handle) {
  cudaGraphConditionalHandle h = 0;
  int err = cond_begin(cudaGraphCondTypeWhile, cond, body, stream, &h);
  *handle = h;
  return err;
}

SLAM_API int slam_while_end(const bool* cond, unsigned long long handle,
                            cudaStream_t body) {
  set_condition<<<1, 1, 0, body>>>(handle, cond);
  int err = cudaGetLastError();
  cudaGraph_t graph;
  int end = cudaStreamEndCapture(body, &graph);
  return err != cudaSuccess ? err : end;
}

#else

SLAM_API int slam_if_begin(const bool*, cudaStream_t, cudaStream_t) {
  return cudaErrorNotSupported;
}

SLAM_API int slam_if_end(cudaStream_t) { return cudaErrorNotSupported; }

SLAM_API int slam_while_begin(const bool*, cudaStream_t, cudaStream_t,
                              unsigned long long*) {
  return cudaErrorNotSupported;
}

SLAM_API int slam_while_end(const bool*, unsigned long long, cudaStream_t) {
  return cudaErrorNotSupported;
}

#endif
