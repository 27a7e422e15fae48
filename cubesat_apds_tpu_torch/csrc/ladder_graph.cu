// The capacity ladder's graph: a CUDA graph whose SWITCH node runs one of n
// captured bodies, chosen on the device (sm_90a).
//
// Counterpart of the JAX package's lax.switch over the capacity ladder
// (cubesat_apds_tpu/ops/features/akaze.py: _adaptive_orient_describe and
// _adaptive_orient_describe_batched). No Pallas kernel is replaced: the
// switch is control flow, and torch 2.11 exposes no conditional nodes, so
// the graph is assembled here through the CUDA runtime (12.8+ for SWITCH).
//
// The graph is: head -> select -> switch(body 0 | ... | body n-1).
//   head    a child graph captured by PyTorch: the batch's largest live
//           count, its rung index written to `idx`, the outputs zeroed;
//   select  one thread copies *idx into the switch's conditional handle;
//   body r  a child graph captured by PyTorch: orientation and MLDB on the
//           first buckets[r] slots (kernel B inside, like every torch op).
// Exactly one body runs per launch; an index outside [0, n) runs none. The
// bodies share one PyTorch memory pool, which is safe because no two of
// them ever run in the same launch.

#include <cuda_runtime.h>
#include <stdlib.h>

__global__ void ladder_select_kernel(const int* __restrict__ idx,
                                     cudaGraphConditionalHandle handle) {
    cudaGraphSetConditional(handle, (unsigned int)max(*idx, 0));
}

#define LADDER_CHECK(call)                         \
    do {                                           \
        cudaError_t e_ = (call);                   \
        if (e_ != cudaSuccess) {                   \
            cudaGraphDestroy(graph);               \
            return (int)e_;                        \
        }                                          \
    } while (0)

// Builds and instantiates the ladder's graph on `device` from the head and
// the n bodies (cudaGraph_t handles; each is cloned, so the caller may
// destroy its own after this returns, but must keep every buffer they use).
// `idx` is the device int32 the head writes and the select kernel reads.
// On success out[0] holds the graph and out[1] its executable.
extern "C" int apds_ladder_graph(int device, void* head, void* const* bodies,
                                 int n, const int* idx, void** out) {
    if (n < 1 || !head || !bodies || !idx || !out) {
        return (int)cudaErrorInvalidValue;
    }
    cudaError_t e = cudaSetDevice(device);
    if (e != cudaSuccess) return (int)e;
    cudaGraph_t graph = nullptr;
    e = cudaGraphCreate(&graph, 0);
    if (e != cudaSuccess) return (int)e;

    cudaGraphNode_t head_node;
    LADDER_CHECK(cudaGraphAddChildGraphNode(&head_node, graph, nullptr, 0,
                                            (cudaGraph_t)head));
    cudaGraphConditionalHandle handle;
    LADDER_CHECK(cudaGraphConditionalHandleCreate(&handle, graph, 0,
                                                  cudaGraphCondAssignDefault));
    void* args[] = {(void*)&idx, (void*)&handle};
    cudaKernelNodeParams kp = {};
    kp.func = (void*)ladder_select_kernel;
    kp.gridDim = dim3(1);
    kp.blockDim = dim3(1);
    kp.kernelParams = args;
    cudaGraphNode_t select_node;
    LADDER_CHECK(
        cudaGraphAddKernelNode(&select_node, graph, &head_node, 1, &kp));

    cudaGraphNodeParams cp = {};
    cp.type = cudaGraphNodeTypeConditional;
    cp.conditional.handle = handle;
    cp.conditional.type = cudaGraphCondTypeSwitch;
    cp.conditional.size = (unsigned int)n;
    cudaGraphNode_t switch_node;
    LADDER_CHECK(cudaGraphAddNode(&switch_node, graph, &select_node, 1, &cp));
    for (int r = 0; r < n; ++r) {
        cudaGraphNode_t body_node;
        LADDER_CHECK(cudaGraphAddChildGraphNode(
            &body_node, cp.conditional.phGraph_out[r], nullptr, 0,
            (cudaGraph_t)bodies[r]));
    }
    cudaGraphExec_t exec;
    LADDER_CHECK(cudaGraphInstantiate(&exec, graph, 0));
    out[0] = (void*)graph;
    out[1] = (void*)exec;
    return 0;
}

// Launches the instantiated graph on `stream`; returns cudaGetLastError()'s
// equivalent for the launch.
extern "C" int apds_graph_launch(void* exec, void* stream) {
    return (int)cudaGraphLaunch((cudaGraphExec_t)exec, (cudaStream_t)stream);
}

// Destroys what apds_ladder_graph made. The caller has synchronised: no
// launch of `exec` may still run.
extern "C" int apds_graph_destroy(void* graph, void* exec) {
    cudaError_t e = cudaGraphExecDestroy((cudaGraphExec_t)exec);
    cudaError_t g = cudaGraphDestroy((cudaGraph_t)graph);
    return (int)(e != cudaSuccess ? e : g);
}

// Counts the nodes of `graph` (one level, child graphs not entered):
// counts[0] all nodes, [1] kernel nodes, [2] memcpy nodes, [3] memset
// nodes. Used to report how many device kernels one replay of a captured
// step runs, which a profiler's trace does not attribute reliably.
extern "C" int apds_graph_node_counts(void* graph, int* counts) {
    if (!graph || !counts) return (int)cudaErrorInvalidValue;
    size_t n = 0;
    cudaError_t e = cudaGraphGetNodes((cudaGraph_t)graph, nullptr, &n);
    if (e != cudaSuccess) return (int)e;
    counts[0] = (int)n;
    counts[1] = counts[2] = counts[3] = 0;
    if (n == 0) return 0;
    cudaGraphNode_t* nodes =
        (cudaGraphNode_t*)malloc(n * sizeof(cudaGraphNode_t));
    if (!nodes) return (int)cudaErrorMemoryAllocation;
    e = cudaGraphGetNodes((cudaGraph_t)graph, nodes, &n);
    for (size_t i = 0; e == cudaSuccess && i < n; ++i) {
        cudaGraphNodeType type;
        e = cudaGraphNodeGetType(nodes[i], &type);
        if (e != cudaSuccess) break;
        if (type == cudaGraphNodeTypeKernel) ++counts[1];
        if (type == cudaGraphNodeTypeMemcpy) ++counts[2];
        if (type == cudaGraphNodeTypeMemset) ++counts[3];
    }
    free(nodes);
    return (int)e;
}
