// Conditional IF nodes in a CUDA graph that PyTorch captures
// (unires_torch/utils/graph.py: cond).
//
// PyTorch 2.11 captures a stream into a graph but has no way to add a
// conditional node to it. These two functions do what later PyTorch
// releases do inside CUDAGraph::begin_capture_to_if_node (CUDA 12.4+):
//   unires_if_begin  on the capturing stream `parent`: create a conditional
//                    handle in the graph being captured, launch a one-thread
//                    kernel that sets it from the device bool *pred (read at
//                    every replay), add an IF node after it, make the node
//                    the stream's capture dependency, and begin capturing
//                    the stream `body` into the node's body graph;
//   unires_if_end    end the capture of `body`: what was launched on it in
//                    between runs at replay only where *pred held.
// An IF node's body may hold further IF nodes (another body stream). Both
// return a cudaError_t (0 on success), -1 when `parent` is not capturing.
// Plain C interface, loaded with ctypes by unires_torch/ops/cuda_build.py.

#include <cuda_runtime.h>

namespace {

__global__ void set_condition(cudaGraphConditionalHandle handle,
                              const bool* pred) {
  cudaGraphSetConditional(handle, *pred ? 1u : 0u);
}

}  // namespace

extern "C" {

int unires_if_begin(const bool* pred, void* parent, void* body) {
  cudaStream_t s = (cudaStream_t)parent;
  cudaStreamCaptureStatus status;
  cudaGraph_t graph;
  cudaError_t e =
      cudaStreamGetCaptureInfo(s, &status, nullptr, &graph, nullptr, nullptr);
  if (e != cudaSuccess) return (int)e;
  if (status != cudaStreamCaptureStatusActive) return -1;
  cudaGraphConditionalHandle handle;
  e = cudaGraphConditionalHandleCreate(&handle, graph, 0, 0);
  if (e != cudaSuccess) return (int)e;
  set_condition<<<1, 1, 0, s>>>(handle, pred);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const cudaGraphNode_t* deps = nullptr;
  size_t n_deps = 0;
  e = cudaStreamGetCaptureInfo(s, &status, nullptr, &graph, &deps, &n_deps);
  if (e != cudaSuccess) return (int)e;
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = cudaGraphCondTypeIf;
  params.conditional.size = 1;
  cudaGraphNode_t node;
  e = cudaGraphAddNode(&node, graph, deps, n_deps, &params);
  if (e != cudaSuccess) return (int)e;
  e = cudaStreamUpdateCaptureDependencies(s, &node, 1,
                                          cudaStreamSetCaptureDependencies);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaStreamBeginCaptureToGraph(
      (cudaStream_t)body, params.conditional.phGraph_out[0], nullptr, nullptr,
      0, cudaStreamCaptureModeThreadLocal);
}

int unires_if_end(void* body) {
  cudaGraph_t graph;
  return (int)cudaStreamEndCapture((cudaStream_t)body, &graph);
}

}  // extern "C"
