// Kernel A: one FED nonlinear-diffusion cycle per launch, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels in cubesat_apds_tpu/ops/pallas/diffusion.py:
// _fed_cycle_kernel (whole image in VMEM, launched by _fed_cycle_pallas) and
// _strip_kernel (row strips with a halo, launched by _fed_cycle_strips).
//
// What it computes: n explicit steps of
//     L <- L + tau_k/2 * sum over the 4 neighbours q of (g_p + g_q)(L_q - L_p)
// with the conductance g fixed and a Neumann boundary (a neighbour outside
// the image is the pixel itself, so that edge carries no flux).
//
// What bounds it on the H100: not the bytes (L and g read once, L written
// once: 12 B a pixel, ~4 us for a frame's 15 cycles) but the chain of n
// dependent steps, each a round of neighbour exchange. The main path's
// small levels (64^2 to 256^2, 4 to 29 steps) are too small to fill 132
// SMs with one block per output tile, so each step's latency on the few
// busy SMs sets the time.
//
// What the design does about it:
// - A tile of output cells is staged with a halo of n cells (clipped to the
//   image) and all n steps run on chip: two HBM transits per cycle. A cell
//   whose distance to the staged region's edge is d is exact after s steps
//   whenever d >= s, so with a halo of n the tile is exact after n steps.
//   Neighbours clamp to the STAGED REGION: where it meets the image edge
//   that is exactly the Neumann clamp; elsewhere the clamped values are
//   wrong but stay in the halo. No cell outside the image is ever staged.
// - On the small levels a thread-block cluster of C CTAs (up to 16) shares
//   one staged tile, each CTA a strip of ceil(rows / C) of its rows, so
//   their steps run on up to 132 SMs instead of 1 to 64. Strips trade edge
//   rows with their two neighbours through distributed shared memory
//   (st.async into the neighbour's ghost rows, counted by its mbarrier),
//   with no cluster-wide barrier in the step loop. The plan
//   (ops/kernels/diffusion.py:fed_plan) takes C = 1, plain halo tiles,
//   where the tile grid already fills the card.
// - Each thread owns up to CPT cells of one column. Their conductance sums
//   g_p + g_q and their L live in registers from before the first step, and
//   so do the vertical neighbours inside the column: a cell-step reads ~2
//   values from shared memory, does 13 flops and stores 1, with no divide
//   and no index clamp in the loop. g never enters shared memory.
//
// - A batch of B images of one shape, with one tau schedule (the schedule
//   depends on the level, not on the image), is one launch: gridDim.z = B
//   over the tile or cluster grid of one image, so the small levels of a
//   frame batch fill B times as many SMs.
//
// Every arithmetic operation uses an _rn intrinsic so nvcc cannot contract
// a multiply and an add into an FMA: the result is the same bits as the
// plain PyTorch twin (ops/kernels/diffusion.py:nld_step), in its term order
// (right, left, down, up) and with L + (tau/2) * contrib. g_p + g_q is the
// same float addition whether it is done once or at every step.

#include <cuda_runtime.h>
#include <stdint.h>

#define FED_MAX_STEPS 128
#define FED_MAX_THREADS 512
#define FED_MAX_CLUSTER 16

struct FedHalfTaus {
    float v[FED_MAX_STEPS];   // 0.5 * tau_k, passed by value (kernel params)
};

__device__ __forceinline__ uint32_t cluster_rank() {
    uint32_t r;
    asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
    return r;
}

__device__ __forceinline__ uint32_t cluster_count() {
    uint32_t r;
    asm volatile("mov.u32 %0, %%cluster_nctarank;" : "=r"(r));
    return r;
}

__device__ __forceinline__ uint32_t cluster_index() {
    uint32_t r;
    asm volatile("mov.u32 %0, %%clusterid.x;" : "=r"(r));
    return r;
}

// The shared::cluster address of `addr` (a shared::cta address) in CTA
// `rank` of this cluster.
__device__ __forceinline__ uint32_t map_rank(uint32_t addr, uint32_t rank) {
    uint32_t r;
    asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
                 : "=r"(r) : "r"(addr), "r"(rank));
    return r;
}

__device__ __forceinline__ float ld_local(uint32_t addr) {
    float v;
    asm volatile("ld.shared.f32 %0, [%1];" : "=f"(v) : "r"(addr) : "memory");
    return v;
}

__device__ __forceinline__ void st_local(uint32_t addr, float v) {
    asm volatile("st.shared.f32 [%0], %1;" :: "r"(addr), "f"(v) : "memory");
}

// A store into another CTA's shared memory that does not stall the thread:
// on arrival it counts its 4 bytes off that CTA's mbarrier `bar`.
__device__ __forceinline__ void st_remote(uint32_t addr, float v, uint32_t bar) {
    asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 "
                 "[%0], %1, [%2];"
                 :: "r"(addr), "r"(__float_as_uint(v)), "r"(bar) : "memory");
}

__device__ __forceinline__ void bar_init(uint32_t bar) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" :: "r"(bar) : "memory");
}

// Opens the barrier's next phase: it completes once `bytes` have arrived.
__device__ __forceinline__ void bar_expect(uint32_t bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                 :: "r"(bar), "r"(bytes) : "memory");
}

// Waits for the barrier's phase of `parity`; traps (a launch error, not a
// hang) if it has not completed after ~2^24 polls, seconds of waiting.
__device__ __forceinline__ void bar_wait(uint32_t bar, uint32_t parity) {
    uint32_t done, polls = 0;
    do {
        if (++polls == (1u << 24)) __trap();
        asm volatile("{\n\t.reg .pred p;\n\t"
                     "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 "
                     "p, [%1], %2;\n\tselp.u32 %0, 1, 0, p;\n\t}"
                     : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    } while (!done);
}

// Every thread of every CTA in the cluster, with no memory ordering of its
// own (a release arrive makes every thread fence, which costs several
// times a step's work); the wait still acquires what a fence released
// before the arrive.
__device__ __forceinline__ void cluster_barrier() {
    asm volatile("barrier.cluster.arrive.relaxed.aligned;\n\t"
                 "barrier.cluster.wait.aligned;" ::: "memory");
}

#define FED_BARRIER_BYTES 16      // two mbarriers ahead of a cluster's buffers

// Grid: C * tiles_y * tiles_x CTAs in clusters of C along x (C = 1 for
// CLUSTER false), times B images along z; cluster i is output tile
// (i / tiles_x, i % tiles_x) of image blockIdx.z.
// Dynamic shared memory: two buffers (ping-pong) of the CTA's strip of
// s = ceil(staged rows / C) rows of the staged width; in a cluster also a
// ghost row above and below the strip, and ahead of the buffers one
// mbarrier per buffer.
//
// Threads: thread t owns column x = t % width, rows [CPT * j, CPT * j +
// CPT) of the strip with j = t / width (a 2-D layout, computed once). Its
// cells' vertical neighbours are its own registers, except above its first
// and below its last cell, so a cell-step reads ~2 + 2/CPT values from
// shared memory.
//
// In a cluster a CTA synchronises with its two neighbours only, never
// with the whole cluster (a cluster barrier with release semantics at
// every step cost more than the step itself). Each step it writes its
// strip's first and last rows into the ghost rows of the CTAs above and
// below with st.async, which counts the bytes off the receiver's mbarrier
// for that buffer; the receiver waits for the mbarrier before it reads the
// ghost rows. One __syncthreads a step orders the CTA's own cells.
// Ping-pong needs nothing more: a neighbour can write into a buffer again
// (two steps later) only after it has this CTA's next edge rows, which
// the threads that read that ghost row send after their reads.
template <int CPT, bool CLUSTER>
__global__ void __launch_bounds__(FED_MAX_THREADS)
fed_cycle_kernel(const float* __restrict__ L, const float* __restrict__ g,
                 float* __restrict__ out, int H, int W, int tile_h,
                 int tile_w, int tiles_x, int n_steps, FedHalfTaus half_taus) {
    extern __shared__ __align__(16) float smem[];
    const size_t image = (size_t)blockIdx.z * H * W;
    L += image;
    g += image;
    out += image;
    const int C = CLUSTER ? (int)cluster_count() : 1;
    const int rank = CLUSTER ? (int)cluster_rank() : 0;
    const int tile = CLUSTER ? (int)cluster_index() : (int)blockIdx.x;
    const int ty = tile / tiles_x, tx = tile - ty * tiles_x;
    const int tr0 = ty * tile_h, tc0 = tx * tile_w;
    const int tr1 = min(tr0 + tile_h, H), tc1 = min(tc0 + tile_w, W);
    // Staged region: the tile plus n cells of halo, clipped to the image.
    const int r0 = max(tr0 - n_steps, 0), r1 = min(tr1 + n_steps, H);
    const int c0 = max(tc0 - n_steps, 0), c1 = min(tc1 + n_steps, W);
    const int R = r1 - r0, sw = c1 - c0;
    // This CTA's strip: staged rows [y0, y0 + rows), buffer rows from
    // `ghost` on.
    constexpr int ghost = CLUSTER ? 1 : 0;
    const int s = (R + C - 1) / C;
    const int y0 = rank * s;
    const int rows = max(0, min(s, R - y0));
    const uint32_t bars = (uint32_t)__cvta_generic_to_shared(smem);
    const uint32_t base = bars + (CLUSTER ? FED_BARRIER_BYTES : 0);
    const uint32_t pitch = 4u * (uint32_t)sw;
    const uint32_t buf = (uint32_t)(s + 2 * ghost) * pitch;
    // Where this CTA's first row goes in the CTA above (its lower ghost
    // row), its last row in the CTA below (its upper ghost row), and the
    // mbarriers that count them there.
    const uint32_t up_ghost = CLUSTER && rank > 0
        ? map_rank(base + (uint32_t)(s + 1) * pitch, rank - 1) : 0u;
    const uint32_t up_bars = CLUSTER && rank > 0 ? map_rank(bars, rank - 1) : 0u;
    const uint32_t down_ghost = CLUSTER && rank + 1 < C
        ? map_rank(base, rank + 1) : 0u;
    const uint32_t down_bars = CLUSTER && rank + 1 < C
        ? map_rank(bars, rank + 1) : 0u;
    // Bytes that arrive into this CTA's ghost rows each step: the row above
    // from a full strip above when this strip has rows, the row below from
    // a strip below when that one has rows.
    const uint32_t bytes_in =
        pitch * ((rank > 0 && rows > 0) + (R > (rank + 1) * s));

    // This thread's segment: m cells of column x from strip row ly0 on,
    // staged row y on; a0 is its first cell in buffer 0.
    const int t = threadIdx.x;
    const int seg = t / sw, x = t - seg * sw;
    const int ly0 = seg * CPT;
    const int m = max(0, min(CPT, rows - ly0));
    const int y = y0 + ly0;
    const uint32_t a0 = base + (uint32_t)(ly0 + ghost) * pitch + 4u * (uint32_t)x;
    const uint32_t a_below = a0 + (uint32_t)m * pitch;
    // Left and right neighbours clamp to the staged columns, the rows
    // above and below to the staged rows (then the cell itself is read).
    const uint32_t dl = x > 0 ? 4u : 0u, dr = x + 1 < sw ? 4u : 0u;
    const bool has_up = m > 0 && y > 0, has_down = m > 0 && y + m < R;
    const bool push_up = CLUSTER && m > 0 && ly0 == 0 && rank > 0;
    const bool push_down = CLUSTER && m > 0 && ly0 + m == s && has_down;
    const uint32_t p_up = up_ghost + 4u * (uint32_t)x;
    const uint32_t p_down = down_ghost + 4u * (uint32_t)x;

    if (CLUSTER && t == 0) {
        bar_init(bars);
        bar_init(bars + 8);
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
        bar_expect(bars, bytes_in);
        if (n_steps > 1) bar_expect(bars + 8, bytes_in);
    }

    float lc[CPT], g_r[CPT], g_l[CPT], g_d[CPT], g_u[CPT];
    float last = 0.0f;                     // lc[m - 1]
#pragma unroll
    for (int k = 0; k < CPT; ++k) {
        lc[k] = g_r[k] = g_l[k] = g_d[k] = g_u[k] = 0.0f;
        if (k < m) {
            const size_t gi = (size_t)(r0 + y + k) * W + (c0 + x);
            const float gc = g[gi];
            g_r[k] = __fadd_rn(gc, g[gi + (dr >> 2)]);
            g_l[k] = __fadd_rn(gc, g[gi - (dl >> 2)]);
            g_d[k] = __fadd_rn(gc, g[y + k + 1 < R ? gi + W : gi]);
            g_u[k] = __fadd_rn(gc, g[y + k > 0 ? gi - W : gi]);
            lc[k] = L[gi];
            last = lc[k];
            st_local(a0 + (uint32_t)k * pitch, lc[k]);
        }
    }
    __syncthreads();
    if (CLUSTER) {
        // Every CTA's mbarriers are set up (fence.mbarrier_init above)
        // before any edge row is sent.
        cluster_barrier();
        if (push_up) st_remote(p_up, lc[0], up_bars);
        if (push_down) st_remote(p_down, last, down_bars);
    }

    // Cells go in groups of up to 4: a group's loads are all issued before
    // its arithmetic, so their latencies overlap.
    constexpr int G = CPT < 4 ? CPT : 4;
    for (int step = 0; step < n_steps; ++step) {
        const uint32_t b = (uint32_t)(step & 1), cur = b * buf, nxt = buf - cur;
        const float ht = half_taus.v[step];
        if (CLUSTER) bar_wait(bars + 8u * b, (uint32_t)(step >> 1) & 1u);
        float up = has_up ? ld_local(a0 + cur - pitch) : lc[0];
        const float below = has_down ? ld_local(a_below + cur) : last;
#pragma unroll
        for (int k0 = 0; k0 < CPT; k0 += G) {
            float lr[G], ll[G];
#pragma unroll
            for (int j = 0; j < G; ++j) {
                if (k0 + j < m) {
                    const uint32_t a = a0 + cur + (uint32_t)(k0 + j) * pitch;
                    lr[j] = ld_local(a + dr);
                    ll[j] = ld_local(a - dl);
                }
            }
#pragma unroll
            for (int j = 0; j < G; ++j) {
                const int k = k0 + j;
                if (k < m) {
                    const float old = lc[k];
                    float down = below;
                    if (k + 1 < CPT && k + 1 < m) down = lc[k + 1];
                    const float t_r = __fmul_rn(g_r[k], __fsub_rn(lr[j], old));
                    const float t_l = __fmul_rn(g_l[k], __fsub_rn(ll[j], old));
                    const float t_d = __fmul_rn(g_d[k], __fsub_rn(down, old));
                    const float t_u = __fmul_rn(g_u[k], __fsub_rn(up, old));
                    const float contrib =
                        __fadd_rn(__fadd_rn(__fadd_rn(t_r, t_l), t_d), t_u);
                    lc[k] = __fadd_rn(old, __fmul_rn(ht, contrib));
                    up = old;
                    last = lc[k];
                    st_local(a0 + nxt + (uint32_t)k * pitch, lc[k]);
                }
            }
        }
        if (CLUSTER && step + 1 < n_steps) {
            if (push_up) st_remote(p_up + nxt, lc[0], up_bars + 8u * (b ^ 1u));
            if (push_down) st_remote(p_down + nxt, last, down_bars + 8u * (b ^ 1u));
        }
        __syncthreads();
        // Every thread is past this step's wait: open the mbarrier's phase
        // for the step after next.
        if (CLUSTER && t == 0 && step + 2 < n_steps) {
            bar_expect(bars + 8u * b, bytes_in);
        }
    }
    // No CTA leaves while a neighbour may still send to it.
    if (CLUSTER) cluster_barrier();

#pragma unroll
    for (int k = 0; k < CPT; ++k) {
        const int row = r0 + y + k, col = c0 + x;
        if (k < m && row >= tr0 && row < tr1 && col >= tc0 && col < tc1) {
            out[(size_t)row * W + col] = lc[k];
        }
    }
}

#define FED_KERNELS 10            // CPT in {1, 2, 4, 8, 16}, cluster or not

typedef void (*FedKernel)(const float*, const float*, float*, int, int, int,
                          int, int, int, FedHalfTaus);

// The kernel for cpt cells per thread (1, 2, 4, 8 or 16), in a cluster or not,
// and its slot in the attribute state below; nullptr for another cpt.
static FedKernel kernel_for(int cpt, int cluster, int* slot) {
    static const FedKernel kernels[FED_KERNELS] = {
        fed_cycle_kernel<1, false>, fed_cycle_kernel<1, true>,
        fed_cycle_kernel<2, false>, fed_cycle_kernel<2, true>,
        fed_cycle_kernel<4, false>, fed_cycle_kernel<4, true>,
        fed_cycle_kernel<8, false>, fed_cycle_kernel<8, true>,
        fed_cycle_kernel<16, false>, fed_cycle_kernel<16, true>};
    const int lg = cpt == 1 ? 0 : cpt == 2 ? 1 : cpt == 4 ? 2 : cpt == 8 ? 3
                 : cpt == 16 ? 4 : -1;
    if (lg < 0) return nullptr;
    *slot = 2 * lg + (cluster > 1);
    return kernels[*slot];
}

// Function attributes are host calls: each is set once per kernel, the
// shared-memory limit again only when a launch needs more than before.
static cudaError_t ensure_attributes(FedKernel fn, int slot, int smem_bytes,
                                     int cluster) {
    static int smem_set[FED_KERNELS];
    static bool cluster16_set[FED_KERNELS];
    cudaError_t err = cudaSuccess;
    if (smem_bytes > smem_set[slot]) {
        err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   smem_bytes);
        if (err != cudaSuccess) return err;
        smem_set[slot] = smem_bytes;
    }
    if (cluster > 8 && !cluster16_set[slot]) {
        err = cudaFuncSetAttribute(fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
        if (err != cudaSuccess) return err;
        cluster16_set[slot] = true;
    }
    return err;
}

// A launch configuration of `ctas` CTAs in clusters of `cluster` along x,
// for `batch` images along z (no cluster attribute for 1: plain tiles).
static void fill_config(cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr,
                        int ctas, int batch, int cluster, int threads,
                        int smem_bytes, cudaStream_t stream) {
    *cfg = cudaLaunchConfig_t{};
    cfg->gridDim = dim3((unsigned)ctas, 1u, (unsigned)batch);
    cfg->blockDim = dim3((unsigned)threads);
    cfg->dynamicSmemBytes = (size_t)smem_bytes;
    cfg->stream = stream;
    attr->id = cudaLaunchAttributeClusterDimension;
    attr->val.clusterDim.x = (unsigned)cluster;
    attr->val.clusterDim.y = 1;
    attr->val.clusterDim.z = 1;
    cfg->attrs = attr;
    cfg->numAttrs = cluster > 1 ? 1 : 0;
}

// Threads and shared-memory bytes per CTA that a plan needs, from its
// largest staged region (an interior tile).
static void plan_size(int H, int W, int tile_h, int tile_w, int cluster,
                      int cpt, int n_steps, long long* threads,
                      long long* smem) {
    const long long R = H < tile_h + 2 * n_steps ? H : tile_h + 2 * n_steps;
    const long long sw = W < tile_w + 2 * n_steps ? W : tile_w + 2 * n_steps;
    const long long s = (R + cluster - 1) / cluster;
    *threads = sw * ((s + cpt - 1) / cpt);
    *smem = cluster > 1 ? FED_BARRIER_BYTES + 2 * 4 * (s + 2) * sw
                        : 2 * 4 * s * sw;
}

static bool plan_ok(int H, int W, int batch, int tile_h, int tile_w,
                    int cluster, int threads, int cpt, int n_steps,
                    int smem_bytes) {
    if (n_steps < 1 || n_steps > FED_MAX_STEPS || H < 1 || W < 1 ||
        batch < 1 || batch > 65535 ||
        tile_h < 1 || tile_w < 1 || threads < 32 || threads % 32 != 0 ||
        threads > FED_MAX_THREADS || cluster < 1 || cluster > FED_MAX_CLUSTER ||
        (cluster & (cluster - 1)) != 0) {
        return false;
    }
    long long need, smem;
    plan_size(H, W, tile_h, tile_w, cluster, cpt, n_steps, &need, &smem);
    const long long ctas = (long long)cluster * ((W + tile_w - 1) / tile_w) *
                           ((H + tile_h - 1) / tile_h);
    return need <= threads && smem <= smem_bytes && ctas <= 0x7fffffffLL;
}

// Launches one cycle of each of `batch` H x W images (contiguous, one
// after another in L, g and out) on `stream` with the plan of
// diffusion.py:fed_plan: output tiles of tile_h x tile_w, each staged with
// a halo of n_steps and
// split over a cluster of `cluster` CTAs (1 = plain tiles) of `threads`
// threads owning up to `cpt` cells of a column each. half_taus is a HOST array of
// n_steps floats (copied into the kernel's parameters). smem_bytes must
// cover 16 + 8 * (s + 2) * min(W, tile_w + 2n) with s = ceil(min(H,
// tile_h + 2n) / cluster) (8 * s * ... for plain tiles: no ghost rows, no
// mbarriers).
// Returns a cudaError_t: invalid value for a plan that does not fit,
// else cudaGetLastError() after the launch.
extern "C" int apds_fed_cycle(const float* L, const float* g, float* out,
                              int batch, int H, int W, int tile_h, int tile_w,
                              int cluster, int threads, int cpt,
                              const float* half_taus, int n_steps,
                              int smem_bytes, void* stream) {
    int slot = 0;
    const FedKernel fn = kernel_for(cpt, cluster, &slot);
    if (fn == nullptr || !plan_ok(H, W, batch, tile_h, tile_w, cluster,
                                  threads, cpt, n_steps, smem_bytes)) {
        return (int)cudaErrorInvalidValue;
    }
    cudaError_t err = ensure_attributes(fn, slot, smem_bytes, cluster);
    if (err != cudaSuccess) return (int)err;
    FedHalfTaus t;
    for (int k = 0; k < n_steps; ++k) t.v[k] = half_taus[k];
    for (int k = n_steps; k < FED_MAX_STEPS; ++k) t.v[k] = 0.0f;
    const int tiles_x = (W + tile_w - 1) / tile_w;
    const int tiles_y = (H + tile_h - 1) / tile_h;
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr;
    fill_config(&cfg, &attr, cluster * tiles_x * tiles_y, batch, cluster,
                threads, smem_bytes, (cudaStream_t)stream);
    err = cudaLaunchKernelEx(&cfg, fn, L, g, out, H, W, tile_h, tile_w,
                             tiles_x, n_steps, t);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
}

// A plan's launch shape as compiled for this card: info[0..2] = the most
// clusters of `cluster` CTAs (threads, smem_bytes each) the card holds at
// once (cudaOccupancyMaxActiveClusters), registers per thread, local
// (spill) bytes per thread of the kernel with `cpt` cells per thread.
extern "C" int apds_fed_cycle_info(int cluster, int threads, int cpt,
                                   int smem_bytes, int* info_out) {
    int slot = 0;
    const FedKernel fn = kernel_for(cpt, cluster, &slot);
    if (fn == nullptr || threads < 32 || threads > FED_MAX_THREADS ||
        cluster < 1 || cluster > FED_MAX_CLUSTER) {
        return (int)cudaErrorInvalidValue;
    }
    cudaError_t err = ensure_attributes(fn, slot, smem_bytes, cluster);
    if (err != cudaSuccess) return (int)err;
    cudaFuncAttributes attr;
    err = cudaFuncGetAttributes(&attr, fn);
    if (err != cudaSuccess) return (int)err;
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute cattr;
    fill_config(&cfg, &cattr, cluster, 1, cluster, threads, smem_bytes, 0);
    cfg.numAttrs = 1;            // the occupancy query takes cluster 1 too
    int clusters = 0;
    err = cudaOccupancyMaxActiveClusters(&clusters, fn, &cfg);
    if (err != cudaSuccess) return (int)err;
    info_out[0] = clusters;
    info_out[1] = attr.numRegs;
    info_out[2] = (int)attr.localSizeBytes;
    return 0;
}
