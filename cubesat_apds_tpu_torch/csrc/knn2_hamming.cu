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
// and vpop[row] = popcount(row) for a valid row, >= 2^29 for an invalid one
// (layout_db_blocks). So a valid row's value is its Hamming distance minus
// popcount(q), and an invalid row never matches. Ties go to the lowest global
// index; the second-best excludes only the winning row, so an equal value at
// another index still counts. The merge kernel adds popcount(q) back and maps
// "no valid row" to d0 = d1 = 3.0e38, i0 = 0: ops.match.knn2_blockwise, bit for
// bit.
//
// What bounds it on the H100: operations. popcount(q AND row) is the int32 dot
// product of the two descriptors' {0,1}-unpacked bits, at most 512, so the
// int8 tensor cores compute it exactly: 2*Q*M*512 ops, >= 1.11 ms at 1,979
// TOP/s for Q = 2048, M = 2^20. The DB is 68 MB (0.02 ms of HBM); each query
// block re-reads it from L2. The first form of this kernel (AND + POPC over 16
// words per pair) was held by the POPC pipe, >= 8.2 ms at that shape.
//
// What the design does about it: the products run as wgmma (warpgroup MMA,
// m64n128k32, s8 x s8 -> s32), the only route to the tensor cores' full rate;
// mma.sync reaches about half of it. Queries are A, held in registers; DB rows
// are B, which wgmma reads from shared memory, K-major.
//  - Bit order. The dot product does not depend on the order of the k axis,
//    so k-step w (32 k) takes word w, and both operands use one permutation
//    of its bits that makes the unpack two integer ops per 32-bit register:
//    k = 4t + i holds bit t + 8i and k = 16 + 4t + i bit t + 4 + 8i
//    (t, i = 0..3). In A's register fragment the lane with threadID_in_group t
//    holds exactly those k, so its registers are (word >> t) & 0x01010101 and
//    (word >> (t + 4)) & 0x01010101; in B's tile, byte k of a row is written
//    in the same order.
//  - Queries. A block of 2 warpgroups owns 128 queries; each warp builds the
//    A fragments of its 16 queries for all 512 bits once (64 registers).
//  - DB rows. The block streams its contiguous DB chunk in tiles of 128 rows.
//    Each thread loads its share of the next tile's packed words (68 B a row,
//    the DB stays packed in device memory) into registers ahead of use and
//    unpacks it into one of two 64 KB shared-memory tiles, laid out as 8-row x
//    16-byte core matrices with no swizzle (K-major: core matrices 128 B apart
//    along k, 4 KB apart along rows), while the tensor cores work on the
//    other tile. mbarriers hand the tiles over: full[b] once all 256 threads
//    have written tile b, empty[b] once both warpgroups are done with it.
//  - Ping-pong. Warpgroup 1 starts one tile behind warpgroup 0; from then on
//    each warpgroup's epilogue and unpack run while the other's products do.
//  - Epilogue, in registers. As in the TPU kernel, a row's value and index
//    travel as one key, (value + 512) << 20 | index in the chunk, so ordering
//    keys orders rows by (value, index): the tie rule. Each accumulator
//    becomes key = base[row] - (dot << 21), with the base made from vpop as
//    the tile is unpacked, and each lane keeps the two smallest keys of its
//    own columns for each of its two query rows (3 integer min/max a pair).
//    At the end of the chunk the 4 lanes that share a query row merge their
//    pairs by quad shuffles (their keys are distinct, so the union's two
//    smallest are exact) and the chunk's partial (d0, d1, i0) is written.
//  - Split. The DB is cut into as many chunks (at most 2^20 rows, the key's
//    index field) as it takes to give every SM several blocks (Q = 2048 is
//    only 16 query blocks); a second small kernel merges the chunks in order
//    with _merge_acc's rule. No atomics: deterministic.

#include <cuda_runtime.h>
#include <stdint.h>

#define KNN_QB 128                  // queries per block: 2 warpgroups x 64
#define KNN_THREADS 256
#define KNN_TILE 128                // DB rows per tile: wgmma N
#define KNN_WORDS 16                // 32-bit words per row = k-steps of 32
#define KNN_STAGES 2
#define KNN_BIG (1 << 29)           // values >= KNN_BIG are invalid rows
#define KNN_VPOP_INVALID (KNN_BIG + 1024)
// Keys: bits 20..31 hold value + 512 (26..1024 for a valid row) or 3071 - 2*dot
// (>= 2047) for an invalid one; bits 0..19 the row's index within its chunk.
#define KNN_COL_BITS 20
#define KNN_MAX_CHUNK (1 << KNN_COL_BITS)
#define KNN_FIELD_INVALID 3071u
#define KNN_FIELD_VALID_MAX 1024u
#define KNN_CORE_BYTES 128          // one 8-row x 16-byte core matrix
#define KNN_ROW_GROUP_BYTES (32 * KNN_CORE_BYTES)   // 8 rows x 512 k
#define KNN_B_BYTES (KNN_TILE * 512)                // one unpacked tile
#define KNN_BAR_OFFSET (KNN_STAGES * (KNN_B_BYTES + KNN_TILE * 4))
#define KNN_SMEM_BYTES (KNN_BAR_OFFSET + 5 * 8)    // + full[2], empty[2], start

// The {0,1} bytes of the 4 bits s, s + 8, s + 16, s + 24 of w.
__device__ __forceinline__ uint32_t bits01(uint32_t w, int s) {
    return (w >> s) & 0x01010101u;
}

// bits01 for the query fragments, as an opaque instruction: it runs once,
// before the DB loop, and its 64 results stay in registers. (As plain C++
// the compiler re-derives them from the packed words inside the loop.)
__device__ __forceinline__ uint32_t bits01_once(uint32_t w, int s) {
    uint32_t r;
    asm volatile("{\n\t.reg .b32 t;\n\tshr.b32 t, %1, %2;\n\t"
                 "and.b32 %0, t, 0x01010101;\n\t}\n"
                 : "=r"(r) : "r"(w), "r"(s));
    return r;
}

// A row's key before its dot product: (vpop + 512) << 20 | column in the
// chunk, or the invalid field. key - (dot << 21) is then
// (value + 512) << 20 | column, and every key of a chunk is distinct.
__device__ __forceinline__ uint32_t key_base(int vpop, int col) {
    const uint32_t f = vpop >= KNN_BIG ? KNN_FIELD_INVALID : (uint32_t)(vpop + 512);
    return (f << KNN_COL_BITS) | (uint32_t)col;
}

// The two smallest distinct keys so far: k0 < k1.
__device__ __forceinline__ void top2_push(uint32_t& k0, uint32_t& k1,
                                          uint32_t key) {
    k1 = min(k1, max(k0, key));
    k0 = min(k0, key);
}

// A key's value field back as the kernel's int value (KNN_BIG if invalid).
__device__ __forceinline__ int key_value(uint32_t key) {
    const uint32_t f = key >> KNN_COL_BITS;
    return f > KNN_FIELD_VALID_MAX ? KNN_BIG : (int)f - 512;
}

// wgmma matrix descriptor of a K-major B tile with no swizzle: start address,
// leading byte offset (between core matrices along k) and stride byte offset
// (between 8-row groups), each in 16-byte units.
__device__ __forceinline__ uint64_t b_desc(uint32_t addr) {
    return (uint64_t)((addr & 0x3FFFF) >> 4)
         | ((uint64_t)(KNN_CORE_BYTES >> 4) << 16)
         | ((uint64_t)(KNN_ROW_GROUP_BYTES >> 4) << 32);
}

// d (+)= A x B for one k-step: 64 queries x 128 rows x 32 bits.
__device__ __forceinline__ void wgmma_s8(int (&d)[64], const uint32_t (&a)[4],
                                         uint64_t desc, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
          "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
          "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
          "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
          "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
          "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate));
}

// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma's issue and wait.
__device__ __forceinline__ void fence_acc(int (&d)[64]) {
#pragma unroll
    for (int i = 0; i < 64; ++i) asm volatile("" : "+r"(d[i]) :: "memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
                 :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
    uint64_t state;
    asm volatile("mbarrier.arrive.shared::cta.b64 %0, [%1];\n"
                 : "=l"(state) : "r"(bar) : "memory");
    (void)state;
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
    uint32_t done;
    asm volatile("{\n.reg .pred p;\n"
                 "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                 "selp.u32 %0, 1, 0, p;\n}\n"
                 : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    return done != 0;
}

// Waits for the phase of `bar` with this parity to complete; traps (a launch
// error, not a hang) if it never does.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
    for (int spins = 0; !mbar_try_wait(bar, parity); ++spins) {
        if (spins > (1 << 22)) __trap();
    }
}

__device__ __forceinline__ void fence_async_smem() {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// grid = (ceil(Q / KNN_QB), n_split). Block (x, s) scans rows
// [s * chunk, min((s + 1) * chunk, M)) for its 128 queries and writes
// partial[s][0 | 1 | 2][q] = (d0, d1, i0) of that chunk.
__global__ void __launch_bounds__(KNN_THREADS, 1)
knn2_partial_kernel(const uint4* __restrict__ q_words,    // [Q, 4] x uint4
                    const uint4* __restrict__ db_words,   // [M, 4] x uint4
                    const int* __restrict__ vpop,         // [M]
                    int* __restrict__ partial,            // [n_split, 3, Q]
                    int Q, int M, int chunk) {
    // [STAGES] unpacked tiles, [STAGES][TILE] key bases, 5 mbarriers.
    extern __shared__ __align__(1024) uint8_t smem[];
    uint32_t* s_key = reinterpret_cast<uint32_t*>(smem + KNN_STAGES * KNN_B_BYTES);
    const uint32_t s_addr = (uint32_t)__cvta_generic_to_shared(smem);
    const uint32_t full = s_addr + KNN_BAR_OFFSET;      // full[b] = full + 8b
    const uint32_t empty = full + 16;                    // empty[b] = empty + 8b
    const uint32_t start = full + 32;
    const int lane = threadIdx.x & 31, wg = threadIdx.x >> 7;
    const int g = lane >> 2, t = lane & 3;        // groupID, threadID_in_group
    const int q_warp = blockIdx.x * KNN_QB + (threadIdx.x >> 5) * 16;
    const int row0 = blockIdx.y * chunk;
    const int row1 = min(row0 + chunk, M);
    const int n_tiles = row1 > row0 ? (row1 - row0 + KNN_TILE - 1) / KNN_TILE : 0;

    if (threadIdx.x == 0) {
        mbar_init(full, KNN_THREADS);
        mbar_init(full + 8, KNN_THREADS);
        mbar_init(empty, KNN_THREADS);
        mbar_init(empty + 8, KNN_THREADS);
        mbar_init(start, KNN_THREADS / 2);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }

    // A fragments of the warp's 16 queries, all 16 k-steps: register j of
    // k-step w holds query row g (j even) or g + 8 (j odd), bits t + 8i
    // (j < 2) or t + 4 + 8i (j >= 2) of word w. Missing queries are 0.
    uint32_t a[KNN_WORDS][4];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const int qi = q_warp + h * 8 + g;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
            const uint4 v = qi < Q ? __ldg(q_words + (size_t)qi * 4 + k)
                                   : make_uint4(0u, 0u, 0u, 0u);
            const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                a[4 * k + j][h] = bits01_once(w[j], t);
                a[4 * k + j][2 + h] = bits01_once(w[j], t + 4);
            }
        }
    }
    __syncthreads();                                     // barriers initialised

    // Each thread loads and unpacks row ur of a tile, words 4uq .. 4uq + 3
    // and 4uq + 8 .. 4uq + 11 (uq = 0, 1); threads with uq = 0 also make the
    // row's key base. Rows past the chunk read as zeros with the invalid key.
    const int ur = threadIdx.x & (KNN_TILE - 1);
    const int uq = threadIdx.x / KNN_TILE;
    uint4 pw[2];
    int pv = KNN_VPOP_INVALID;
    auto fetch = [&](int tile) {
        const int r = row0 + tile * KNN_TILE + ur;
        const bool ok = r < row1;
        const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
        pw[0] = ok ? __ldg(db_words + (size_t)r * 4 + uq) : zero;
        pw[1] = ok ? __ldg(db_words + (size_t)r * 4 + uq + 2) : zero;
        pv = ok && uq == 0 ? __ldg(vpop + r) : KNN_VPOP_INVALID;
    };
    auto unpack = [&](int b, int tile) {
        uint8_t* row = smem + b * KNN_B_BYTES + (ur >> 3) * KNN_ROW_GROUP_BYTES
                     + (ur & 7) * 16;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const uint32_t w4[4] = {pw[h].x, pw[h].y, pw[h].z, pw[h].w};
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const int w = 4 * (uq + 2 * h) + j;     // k-step = 2 core matrices
                const uint32_t x = w4[j];
                *reinterpret_cast<uint4*>(row + 2 * w * KNN_CORE_BYTES) =
                    make_uint4(bits01(x, 0), bits01(x, 1), bits01(x, 2), bits01(x, 3));
                *reinterpret_cast<uint4*>(row + (2 * w + 1) * KNN_CORE_BYTES) =
                    make_uint4(bits01(x, 4), bits01(x, 5), bits01(x, 6), bits01(x, 7));
            }
        }
        if (uq == 0) s_key[b * KNN_TILE + ur] = key_base(pv, tile * KNN_TILE + ur);
        fence_async_smem();          // the generic writes, visible to wgmma
        mbar_arrive(full + 8 * b);
    };

    if (n_tiles > 0) {
        fetch(0);
        unpack(0, 0);
        if (n_tiles > 1) fetch(1);
        // Warpgroup 1 starts one tile behind warpgroup 0, so that each one's
        // epilogue runs while the other's products do.
        if (wg == 1) mbar_wait(start, 0);
    }

    // The two smallest keys for query rows g (h = 0) and g + 8 (h = 1).
    uint32_t k0[2] = {0xffffffffu, 0xffffffffu};
    uint32_t k1[2] = {0xffffffffu, 0xffffffffu};
    int acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0;
    for (int tile = 0; tile < n_tiles; ++tile) {
        const int b = tile & 1;
        mbar_wait(full + 8 * b, (tile >> 1) & 1);
        const uint32_t tile_addr = s_addr + b * KNN_B_BYTES;
        fence_acc(acc);
        asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
        for (int w = 0; w < KNN_WORDS; ++w) {
            wgmma_s8(acc, a[w], b_desc(tile_addr + 2 * w * KNN_CORE_BYTES), w > 0);
        }
        asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
        fence_acc(acc);
        if (tile + 1 < n_tiles) {          // the next tile, into the other stage
            if (tile >= 1) mbar_wait(empty + 8 * (b ^ 1), ((tile - 1) >> 1) & 1);
            unpack(b ^ 1, tile + 1);
            if (tile + 2 < n_tiles) fetch(tile + 2);
        }
        asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
        fence_acc(acc);
        if (tile == 0 && wg == 0) mbar_arrive(start);
        // Accumulator 4j + e: query row g (e < 2) or g + 8, tile row
        // 8j + 2t + (e & 1).
        const uint32_t* keys = s_key + b * KNN_TILE;
#pragma unroll
        for (int j = 0; j < KNN_TILE / 8; ++j) {
            const uint2 kb = *reinterpret_cast<const uint2*>(keys + 8 * j + 2 * t);
            top2_push(k0[0], k1[0], kb.x - ((uint32_t)acc[4 * j] << 21));
            top2_push(k0[0], k1[0], kb.y - ((uint32_t)acc[4 * j + 1] << 21));
            top2_push(k0[1], k1[1], kb.x - ((uint32_t)acc[4 * j + 2] << 21));
            top2_push(k0[1], k1[1], kb.y - ((uint32_t)acc[4 * j + 3] << 21));
        }
        mbar_arrive(empty + 8 * b);
    }

    // The quad's 4 lanes hold disjoint columns of the same query rows, so
    // their keys are distinct: the two smallest of the union are the
    // smaller first keys and the smallest of the rest.
    int* out = partial + (size_t)blockIdx.y * 3 * Q;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        uint32_t s0 = k0[h], s1 = k1[h];
#pragma unroll
        for (int off = 1; off < 4; off <<= 1) {
            const uint32_t b0 = __shfl_xor_sync(0xffffffffu, s0, off);
            const uint32_t b1 = __shfl_xor_sync(0xffffffffu, s1, off);
            s1 = min(min(s1, b1), max(s0, b0));
            s0 = min(s0, b0);
        }
        const int qi = q_warp + h * 8 + g;
        if (t == 0 && qi < Q) {
            const int v0 = key_value(s0);
            out[qi] = v0;
            out[Q + qi] = key_value(s1);
            out[2 * Q + qi] =
                v0 >= KNN_BIG ? 0 : row0 + (int)(s0 & (KNN_MAX_CHUNK - 1));
        }
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
// first CUDA error that is not cudaSuccess. `chunk` must be a multiple of
// KNN_TILE, at most KNN_MAX_CHUNK, and n_split * chunk must cover M;
// `partial` holds n_split * 3 * Q ints.
extern "C" int apds_knn2_hamming(const void* q_words, const void* db_words,
                                 const int* vpop, int* partial, float* d0,
                                 float* d1, int* i0, int Q, int M, int n_split,
                                 int chunk, void* stream) {
    if (Q < 1 || M < 0 || n_split < 1 || n_split > 65535 || chunk < KNN_TILE ||
        chunk > KNN_MAX_CHUNK || chunk % KNN_TILE != 0 ||
        (long long)n_split * chunk < M) {
        return (int)cudaErrorInvalidValue;
    }
    cudaError_t err = cudaFuncSetAttribute(
        knn2_partial_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        KNN_SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((Q + KNN_QB - 1) / KNN_QB, n_split);
    knn2_partial_kernel<<<grid, KNN_THREADS, KNN_SMEM_BYTES, (cudaStream_t)stream>>>(
        (const uint4*)q_words, (const uint4*)db_words, vpop, partial, Q, M, chunk);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    knn2_merge_kernel<<<(Q + 127) / 128, 128, 0, (cudaStream_t)stream>>>(
        partial, (const uint4*)q_words, d0, d1, i0, Q, n_split);
    return (int)cudaGetLastError();
}

// The chunk kernel's launch shape as compiled for this card: info[0..7] =
// queries per block, DB rows per tile, threads per block, dynamic shared
// memory per block (bytes), registers per thread, local (spill) bytes per
// thread, resident blocks per SM, shared-memory stages.
extern "C" int apds_knn2_info(int* info) {
    cudaError_t err = cudaFuncSetAttribute(
        knn2_partial_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        KNN_SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
    cudaFuncAttributes attr;
    err = cudaFuncGetAttributes(&attr, knn2_partial_kernel);
    if (err != cudaSuccess) return (int)err;
    int blocks = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, knn2_partial_kernel, KNN_THREADS, KNN_SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
    info[0] = KNN_QB;
    info[1] = KNN_TILE;
    info[2] = KNN_THREADS;
    info[3] = KNN_SMEM_BYTES;
    info[4] = attr.numRegs;
    info[5] = (int)attr.localSizeBytes;
    info[6] = blocks;
    info[7] = KNN_STAGES;
    return 0;
}
