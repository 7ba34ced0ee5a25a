// What the CUDA runtime says of the decode chain's launches (common.cuh
// `launch_chain`): the runtime's and the driver's versions, and how many of
// a captured graph's edges are programmatic. Stream capture turns a
// programmatic dependent launch into a programmatic edge from CUDA 12.3 on;
// an older runtime or driver captures a full dependency, and the chain then
// runs one kernel after another, as it did before the launches were chained.
// chip_smoke.py's chain phase records both.

#include <cuda_runtime.h>

#include <vector>

// Returns a cudaError_t; 0 on success.
extern "C" int fq3t_cuda_versions(int* runtime, int* driver) {
  cudaError_t err = cudaRuntimeGetVersion(runtime);
  if (err != cudaSuccess) return err;
  return cudaDriverGetVersion(driver);
}

// The edges of `graph` (a cudaGraph_t) and how many of them are
// programmatic. Returns a cudaError_t; cudaErrorNotSupported where the
// runtime the library was built against has no typed edges (before 12.3).
extern "C" int fq3t_graph_edges(void* graph, long long* programmatic, long long* total) {
#if CUDART_VERSION >= 12030
  auto g = static_cast<cudaGraph_t>(graph);
  size_t n = 0;
#if CUDART_VERSION >= 13000
  cudaError_t err = cudaGraphGetEdges(g, nullptr, nullptr, nullptr, &n);
#else
  cudaError_t err = cudaGraphGetEdges_v2(g, nullptr, nullptr, nullptr, &n);
#endif
  if (err != cudaSuccess) return err;
  std::vector<cudaGraphNode_t> from(n), to(n);
  std::vector<cudaGraphEdgeData> data(n);
#if CUDART_VERSION >= 13000
  err = cudaGraphGetEdges(g, from.data(), to.data(), data.data(), &n);
#else
  err = cudaGraphGetEdges_v2(g, from.data(), to.data(), data.data(), &n);
#endif
  if (err != cudaSuccess) return err;
  long long p = 0;
  for (size_t i = 0; i < n; ++i) p += data[i].type == cudaGraphDependencyTypeProgrammatic;
  *programmatic = p;
  *total = static_cast<long long>(n);
  return cudaSuccess;
#else
  (void)graph;
  (void)programmatic;
  (void)total;
  return cudaErrorNotSupported;
#endif
}
