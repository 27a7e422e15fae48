// Kernel B: per-keypoint nearest-neighbour patch sampler, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel cubesat_apds_tpu/ops/pallas/sample_kernel.py:
// _sample_kernel (launched by _sample_pallas through pallas_sampler), and
// serves both per-keypoint stages of AKAZE: the 109-point orientation disc
// and the 441-point MLDB pattern.
//
// What it computes: for keypoint k on level lvl[k] and each of its S integer
// sample points (iy, ix), the 4 bf16 channels (Lt, Lx, Ly, 0) of the packed
// level stack at (clip(iy, 0, h-1), clip(ix, 0, w-1)) of that level, widened
// to float32 — exactly the gather of orientation.py:gather_sampler.
//
// What bounds it on the H100: bytes, and the latency of a data-dependent
// read. Each sample moves 32 B (iy and ix read, one 8-byte texel read, a
// 16-byte result written). The whole stack (16 levels x 512^2 x 8 B = 32 MB)
// fits the 50 MB L2, and a keypoint's samples lie within ~29 px of each
// other, so neighbouring samples share L1 lines.
//
// What the design does about it: a direct gather. One thread per sample on a
// flat grid over K*S reads its (iy, ix) coalesced, clamps level, row and
// column, reads its texel through the read-only cache (__ldg) and writes the
// widened float4 coalesced. Nothing is staged: the TPU kernel's DMA of a
// window around each keypoint (and the port's first version, which staged a
// 61 x 61 window in shared memory) existed because the TPU has no fast gather;
// on Hopper the window cost up to 34x the sampled texels and a barrier in
// front of the first sample. The output is the bf16 bits shifted into
// float32: bit-identical to the plain twin.

#include <cuda_runtime.h>

#define SAMPLE_THREADS 256

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
    return min(max(v, lo), hi);
}

__global__ void __launch_bounds__(SAMPLE_THREADS)
sample_patches_kernel(const uint2* __restrict__ stack,   // [L, Hmax, Wmax] x 4 bf16
                      const int* __restrict__ level_hw,  // [L, 2]
                      const int* __restrict__ lvl,       // [K]
                      const int* __restrict__ iy,        // [K, S]
                      const int* __restrict__ ix,        // [K, S]
                      float4* __restrict__ out,          // [K, S]
                      int n, int S, int L, int Hmax, int Wmax,
                      unsigned long long* __restrict__ launches) {
    // The device's own count of launches, eager or inside a CUDA graph
    // (a profiler's trace does not attribute graph kernels reliably).
    if (launches != nullptr && blockIdx.x == 0 && threadIdx.x == 0) {
        atomicAdd(launches, 1ULL);
    }
    const int i = blockIdx.x * SAMPLE_THREADS + threadIdx.x;
    if (i >= n) return;
    // Level and level size clamped into the stack, so no input can make
    // the kernel read outside it (the plain twin clamps the same way).
    const int l = clampi(__ldg(lvl + i / S), 0, L - 1);
    const int h = clampi(__ldg(level_hw + 2 * l), 1, Hmax);
    const int w = clampi(__ldg(level_hw + 2 * l + 1), 1, Wmax);
    const int yy = clampi(__ldg(iy + i), 0, h - 1);
    const int xx = clampi(__ldg(ix + i), 0, w - 1);
    const uint2 p = __ldg(stack + ((size_t)l * Hmax + yy) * Wmax + xx);
    // Little-endian: channel 0 is the low half of the first word.
    out[i] = make_float4(__uint_as_float(p.x << 16),
                         __uint_as_float(p.x & 0xffff0000u),
                         __uint_as_float(p.y << 16),
                         __uint_as_float(p.y & 0xffff0000u));
}

// Launches one thread per sample on `stream`; returns cudaGetLastError().
// K * S must be below 2^31. `launches` (a device uint64, or null) gains one
// for every launch the device runs.
extern "C" int apds_sample_patches(const void* stack, const int* level_hw,
                                   const int* lvl, const int* iy, const int* ix,
                                   void* out, int K, int S, int L, int Hmax,
                                   int Wmax, void* launches, void* stream) {
    const long long n = (long long)K * S;
    if (K < 1 || S < 1 || L < 1 || Hmax < 1 || Wmax < 1 || n >= (1LL << 31)) {
        return (int)cudaErrorInvalidValue;
    }
    const int blocks = (int)((n + SAMPLE_THREADS - 1) / SAMPLE_THREADS);
    sample_patches_kernel<<<blocks, SAMPLE_THREADS, 0, (cudaStream_t)stream>>>(
        (const uint2*)stack, level_hw, lvl, iy, ix, (float4*)out, (int)n, S, L,
        Hmax, Wmax, (unsigned long long*)launches);
    return (int)cudaGetLastError();
}
