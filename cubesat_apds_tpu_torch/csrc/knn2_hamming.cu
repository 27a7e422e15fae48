// Kernel 4: Hamming kNN-2 of packed binary descriptors, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels in cubesat_apds_tpu/ops/pallas/match_kernel.py:
// _kernel_sweep (DB-block-outer grid) and _kernel_tile (query-outer grid), both
// launched by knn2_fused. It serves the big-DB branch of ops.match.knn_match.
//
// What it computes: for each of Q queries against M DB rows (16 little-endian
// 32-bit words per descriptor, bit 32*w + b = bit b of word w), the best value
// d0, the global index i0 of the best row and the second-best value d1, where
//     value(q, row) = vpop[row] - 2 * popcount(q AND row)
// and vpop[row] = popcount(row) for a valid row, >= 2^29 + 1024 for an invalid
// one. So a valid row's value is its Hamming distance minus popcount(q), and an
// invalid row's is >= 2^29 and never matches. Ties go to the lowest global
// index; the second-best excludes only the winning row, so an equal value at
// another index still counts. The merge kernel adds popcount(q) back and maps
// "no valid row" to d0 = d1 = 3.0e38, i0 = 0: ops.match.knn2_blockwise, bit for
// bit.
//
// What bounds it on the H100: integer operations, not bytes. The DB is read
// once per query block from L2 (64 MB + 4 MB from HBM, ~20 us at 3.35 TB/s),
// but each (query, row) pair costs 16 AND + 16 POPC + the adds. POPC issues at
// 16 results per clock per SM on compute capability 9.0 (CUDA C++ Programming
// Guide, arithmetic instruction throughput), so Q*M*16 POPC at Q = 2048,
// M = 2^20 take >= 8.2 ms on 132 SMs at 1.98 GHz. As an int8 tensor-core product
// on unpacked bits the same work is 2*Q*M*512 ops, >= 1.1 ms at 1,979 TOP/s:
// that is the card's bound, and the route of a later, faster kernel.
//
// What the design does about it (the TPU design is not carried over: its
// DB-outer grid and its accumulator carried across grid steps rely on the
// TPU's in-order grid): each thread owns one query and keeps its 16 words and
// a running (d0, i0, d1) in registers. A block of 128 queries streams a
// contiguous chunk of DB rows through shared memory in tiles of 256 rows (16
// KB, coalesced 16-byte loads); every thread then reads each row as a
// broadcast. The DB is cut into as many chunks as it takes to put several
// blocks on every SM (Q = 2048 is only 16 query blocks). Each chunk leaves a
// partial (d0, d1, i0) per query; a second small kernel merges the chunks in
// order with the JAX kernel's _merge_acc rule. No atomics: the result is
// deterministic.

#include <cuda_runtime.h>
#include <stdint.h>

#define KNN_QB 128                  // queries per block (one per thread)
#define KNN_TILE 256                // DB rows per shared-memory tile
#define KNN_BIG (1 << 29)           // values >= KNN_BIG are invalid rows

__device__ __forceinline__ int and_popc(const uint32_t* q, uint4 a, uint4 b,
                                        uint4 c, uint4 d) {
    return __popc(q[0] & a.x) + __popc(q[1] & a.y) + __popc(q[2] & a.z) +
           __popc(q[3] & a.w) + __popc(q[4] & b.x) + __popc(q[5] & b.y) +
           __popc(q[6] & b.z) + __popc(q[7] & b.w) + __popc(q[8] & c.x) +
           __popc(q[9] & c.y) + __popc(q[10] & c.z) + __popc(q[11] & c.w) +
           __popc(q[12] & d.x) + __popc(q[13] & d.y) + __popc(q[14] & d.z) +
           __popc(q[15] & d.w);
}

// grid = (ceil(Q / KNN_QB), n_split). Block (x, s) scans rows
// [s * chunk, min((s + 1) * chunk, M)) for its 128 queries in index order and
// writes partial[s][0 | 1 | 2][q] = (d0, d1, i0) of that chunk.
__global__ void __launch_bounds__(KNN_QB)
knn2_partial_kernel(const uint4* __restrict__ q_words,    // [Q, 4] x uint4
                    const uint4* __restrict__ db_words,   // [M, 4] x uint4
                    const int* __restrict__ vpop,         // [M]
                    int* __restrict__ partial,            // [n_split, 3, Q]
                    int Q, int M, int chunk) {
    __shared__ uint4 tile[KNN_TILE * 4];
    __shared__ int tile_vpop[KNN_TILE];
    const int qi = blockIdx.x * KNN_QB + threadIdx.x;
    const int row0 = blockIdx.y * chunk;
    const int row1 = min(row0 + chunk, M);

    uint32_t q[16];
    if (qi < Q) {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
            const uint4 v = q_words[(size_t)qi * 4 + k];
            q[4 * k] = v.x; q[4 * k + 1] = v.y; q[4 * k + 2] = v.z; q[4 * k + 3] = v.w;
        }
    } else {
#pragma unroll
        for (int k = 0; k < 16; ++k) q[k] = 0u;
    }

    int d0 = KNN_BIG, d1 = KNN_BIG, i0 = 0;
    for (int t0 = row0; t0 < row1; t0 += KNN_TILE) {
        const int n = min(KNN_TILE, row1 - t0);
        __syncthreads();                      // the previous tile is consumed
        for (int i = threadIdx.x; i < n * 4; i += KNN_QB) {
            tile[i] = db_words[(size_t)t0 * 4 + i];
        }
        for (int i = threadIdx.x; i < n; i += KNN_QB) {
            tile_vpop[i] = vpop[t0 + i];
        }
        __syncthreads();
#pragma unroll 4
        for (int r = 0; r < n; ++r) {
            const int dot = and_popc(q, tile[4 * r], tile[4 * r + 1],
                                     tile[4 * r + 2], tile[4 * r + 3]);
            const int v = tile_vpop[r] - 2 * dot;
            // Rows arrive in index order: a strictly smaller value takes the
            // lead (a tie keeps the lower index), and the old leader or the
            // new row competes for second place.
            const bool better = v < d0;
            d1 = better ? d0 : min(d1, v);
            i0 = better ? t0 + r : i0;
            d0 = better ? v : d0;
        }
    }
    if (qi < Q) {
        int* out = partial + (size_t)blockIdx.y * 3 * Q;
        out[qi] = d0;
        out[Q + qi] = d1;
        out[2 * Q + qi] = i0;
    }
}

// One thread per query: merges the n_split partials in chunk order
// (_merge_acc: a tie goes to the lower index), adds popcount(q) back and
// writes the float distances with the 3.0e38 sentinel.
__global__ void knn2_merge_kernel(const int* __restrict__ partial,
                                  const uint4* __restrict__ q_words,
                                  float* __restrict__ d0_out,
                                  float* __restrict__ d1_out,
                                  int* __restrict__ i0_out,
                                  int Q, int n_split) {
    const int qi = blockIdx.x * blockDim.x + threadIdx.x;
    if (qi >= Q) return;
    int s0 = partial[qi], s1 = partial[Q + qi], si = partial[2 * Q + qi];
    for (int s = 1; s < n_split; ++s) {
        const int* p = partial + (size_t)s * 3 * Q;
        const int b0 = p[qi], b1 = p[Q + qi], bi = p[2 * Q + qi];
        const bool better = (b0 < s0) || (b0 == s0 && bi < si);
        const int loser = better ? s0 : b0;
        s1 = min(min(s1, b1), loser);
        si = better ? bi : si;
        s0 = better ? b0 : s0;
    }
    int popq = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
        const uint4 v = q_words[(size_t)qi * 4 + k];
        popq += __popc(v.x) + __popc(v.y) + __popc(v.z) + __popc(v.w);
    }
    d0_out[qi] = s0 >= KNN_BIG ? 3.0e38f : (float)(s0 + popq);
    d1_out[qi] = s1 >= KNN_BIG ? 3.0e38f : (float)(s1 + popq);
    i0_out[qi] = s0 >= KNN_BIG ? 0 : si;
}

// Launches the chunk kernel and the merge kernel on `stream`; returns the
// first cudaGetLastError() that is not cudaSuccess. `chunk` must be a multiple
// of KNN_TILE and n_split * chunk must cover M; `partial` holds
// n_split * 3 * Q ints.
extern "C" int apds_knn2_hamming(const void* q_words, const void* db_words,
                                 const int* vpop, int* partial, float* d0,
                                 float* d1, int* i0, int Q, int M, int n_split,
                                 int chunk, void* stream) {
    if (Q < 1 || M < 0 || n_split < 1 || n_split > 65535 || chunk < KNN_TILE ||
        chunk % KNN_TILE != 0 || (long long)n_split * chunk < M) {
        return (int)cudaErrorInvalidValue;
    }
    const dim3 grid((Q + KNN_QB - 1) / KNN_QB, n_split);
    knn2_partial_kernel<<<grid, KNN_QB, 0, (cudaStream_t)stream>>>(
        (const uint4*)q_words, (const uint4*)db_words, vpop, partial, Q, M, chunk);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    knn2_merge_kernel<<<(Q + 127) / 128, 128, 0, (cudaStream_t)stream>>>(
        partial, (const uint4*)q_words, d0, d1, i0, Q, n_split);
    return (int)cudaGetLastError();
}
