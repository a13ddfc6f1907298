// Conditional IF and WHILE nodes in a CUDA graph that PyTorch captures
// (unires_torch/utils/graph.py: cond, while_loop).
//
// PyTorch 2.11 captures a stream into a graph but has no way to add a
// conditional node to it. These functions do what later PyTorch releases
// do inside CUDAGraph::begin_capture_to_if_node / _to_while_loop_node
// (CUDA 12.4+):
//   unires_if_begin     on the capturing stream `parent`: create a
//                       conditional handle in the graph being captured,
//                       launch a one-thread kernel that sets it from the
//                       device bool *pred (read at every replay), add an IF
//                       node after it, make the node the stream's capture
//                       dependency, and begin capturing the stream `body`
//                       into the node's body graph;
//   unires_if_end       end the capture of `body`: what was launched on it
//                       in between runs at replay only where *pred held;
//                       the body graph's node count is added to *nodes;
//   unires_while_begin  the same with a WHILE node; the handle is returned
//                       in *handle_out;
//   unires_while_end    launch the setter again at the end of the body
//                       (from the same device bool, which the body has
//                       updated), then end the capture of `body`: at replay
//                       the body runs again and again while *pred holds
//                       (its node count added to *nodes, as unires_if_end);
//   unires_stream_create  a stream of the caller's own (non-blocking), never
//                       shared with PyTorch's stream pool, for a capture or
//                       a conditional node's body;
//   unires_capture_nodes  add the node count of the graph that `stream` is
//                       capturing into to *n (a conditional node counts
//                       one: its body's nodes were added where it ended).
// A body may hold further conditional nodes (another body stream). All
// return a cudaError_t (0 on success), -1 when the stream is not capturing;
// the begin functions name the step that failed in *step (enum Step).
// Plain C interface, loaded with ctypes by unires_torch/ops/cuda_build.py.

#include <cuda_runtime.h>

namespace {

__global__ void set_condition(cudaGraphConditionalHandle handle,
                              const bool* pred) {
  cudaGraphSetConditional(handle, *pred ? 1u : 0u);
}

// The steps of begin_node, reported through *step when one fails.
enum Step { kCaptureInfo = 1, kHandle, kSetter, kDeps, kAddNode, kUpdateDeps,
            kBodyCapture };

int begin_node(const bool* pred, void* parent, void* body,
               cudaGraphConditionalNodeType type,
               cudaGraphConditionalHandle* handle, int* step) {
  cudaStream_t s = (cudaStream_t)parent;
  cudaStreamCaptureStatus status;
  cudaGraph_t graph;
  *step = kCaptureInfo;
  cudaError_t e =
      cudaStreamGetCaptureInfo(s, &status, nullptr, &graph, nullptr, nullptr);
  if (e != cudaSuccess) return (int)e;
  if (status != cudaStreamCaptureStatusActive) return -1;
  *step = kHandle;
  e = cudaGraphConditionalHandleCreate(handle, graph, 0, 0);
  if (e != cudaSuccess) return (int)e;
  *step = kSetter;
  set_condition<<<1, 1, 0, s>>>(*handle, pred);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  *step = kDeps;
  const cudaGraphNode_t* deps = nullptr;
  size_t n_deps = 0;
  e = cudaStreamGetCaptureInfo(s, &status, nullptr, &graph, &deps, &n_deps);
  if (e != cudaSuccess) return (int)e;
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = *handle;
  params.conditional.type = type;
  params.conditional.size = 1;
  cudaGraphNode_t node;
  *step = kAddNode;
  e = cudaGraphAddNode(&node, graph, deps, n_deps, &params);
  if (e != cudaSuccess) return (int)e;
  *step = kUpdateDeps;
  e = cudaStreamUpdateCaptureDependencies(s, &node, 1,
                                          cudaStreamSetCaptureDependencies);
  if (e != cudaSuccess) return (int)e;
  *step = kBodyCapture;
  return (int)cudaStreamBeginCaptureToGraph(
      (cudaStream_t)body, params.conditional.phGraph_out[0], nullptr, nullptr,
      0, cudaStreamCaptureModeThreadLocal);
}

int add_nodes(cudaGraph_t graph, unsigned long long* n) {
  size_t count = 0;
  cudaError_t e = cudaGraphGetNodes(graph, nullptr, &count);
  if (e == cudaSuccess) *n += count;
  return (int)e;
}

int end_body(cudaStream_t body, cudaError_t before, unsigned long long* n) {
  cudaGraph_t graph;
  cudaError_t e = cudaStreamEndCapture(body, &graph);
  if (before != cudaSuccess) return (int)before;
  if (e != cudaSuccess) return (int)e;
  return add_nodes(graph, n);
}

}  // namespace

extern "C" {

int unires_if_begin(const bool* pred, void* parent, void* body, int* step) {
  cudaGraphConditionalHandle handle;
  return begin_node(pred, parent, body, cudaGraphCondTypeIf, &handle, step);
}

int unires_if_end(void* body, unsigned long long* nodes) {
  return end_body((cudaStream_t)body, cudaSuccess, nodes);
}

int unires_while_begin(const bool* pred, void* parent, void* body,
                       unsigned long long* handle_out, int* step) {
  cudaGraphConditionalHandle handle = 0;
  int err =
      begin_node(pred, parent, body, cudaGraphCondTypeWhile, &handle, step);
  *handle_out = (unsigned long long)handle;
  return err;
}

int unires_while_end(unsigned long long handle, const bool* pred, void* body,
                     unsigned long long* nodes) {
  cudaStream_t s = (cudaStream_t)body;
  set_condition<<<1, 1, 0, s>>>((cudaGraphConditionalHandle)handle, pred);
  return end_body(s, cudaGetLastError(), nodes);
}

int unires_stream_create(void** stream) {
  cudaStream_t s = nullptr;
  cudaError_t e = cudaStreamCreateWithFlags(&s, cudaStreamNonBlocking);
  *stream = (void*)s;
  return (int)e;
}

int unires_capture_nodes(void* stream, unsigned long long* n) {
  cudaStreamCaptureStatus status;
  cudaGraph_t graph;
  cudaError_t e = cudaStreamGetCaptureInfo((cudaStream_t)stream, &status,
                                           nullptr, &graph, nullptr, nullptr);
  if (e != cudaSuccess) return (int)e;
  if (status != cudaStreamCaptureStatusActive) return -1;
  return add_nodes(graph, n);
}

}  // extern "C"
