// The refit's exact Procrustes rotation: a batch of 3x3 SVD rotations, for
// Hopper (sm_90a).
//
// Replaces no Pallas kernel. It stands for the float32 SVD of the JAX
// package's exact Procrustes (cubesat_apds_tpu/ops/geometry/epnp.py:
// _procrustes, jnp.linalg.svd at :112), which the port computed with
// torch.linalg.svd: on the card cuSOLVER's info check reads back to the host
// at every call, so the serving step synchronised there and could not be
// captured into a CUDA graph.
//
// What it computes: for each cross-covariance S (3x3 float32, row-major),
// R = U diag(1, 1, sign det(U V^T)) V^T from S = U diag(s) V^T: the rotation
// nearest to S (Kabsch). With (s1, u1, v1) and (s2, u2, v2) the two largest
// singular triplets that rotation is
//     R = u1 v1^T + u2 v2^T + (u1 x u2)(v1 x v2)^T,
// since a rotation maps v1 to u1 and v2 to u2 and so v1 x v2 to u1 x u2;
// the sign of the third singular pair drops out. R is defined wherever
// rank(S) >= 2 (and, where det S < 0, s2 > s3); elsewhere the kernel
// returns one rotation of the many (the identity for S = 0, as LAPACK's SVD
// gives). A non-finite S gives a NaN R, as the plain twin does.
//
// How: one thread a matrix, a one-sided (Hestenes) Jacobi SVD in float64:
// plane rotations on the right orthogonalise S's columns, accumulated in V,
// for a fixed PROC_SWEEPS sweeps over the three column pairs (a pair already
// orthogonal to float64 precision is skipped); the columns' norms are the
// singular values, the normalised columns U. Jacobi converges quadratically
// and a 3x3 needs 3-5 sweeps in float64, so 8 leave the result exact to
// float32 rounding. R is rounded to float32 at the end.
//
// What bounds it on the H100: nothing it can reach. The refit hands it 3
// matrices a frame (the three beta cases), 72 B in and out each; ~1.6k
// float64 operations a matrix. Its time is one launch's. The design keeps
// it one launch with no scratch, no host read and no library call, so it
// runs inside a CUDA graph.

#include <cuda_runtime.h>

#define PROC_THREADS 128
#define PROC_SWEEPS 8
#define PROC_EPS 2.220446049250313e-16   // DBL_EPSILON

__device__ __forceinline__ void cross3(const double a[3], const double b[3],
                                       double c[3]) {
    c[0] = a[1] * b[2] - a[2] * b[1];
    c[1] = a[2] * b[0] - a[0] * b[2];
    c[2] = a[0] * b[1] - a[1] * b[0];
}

// A unit vector orthogonal to the unit vector u: the axis along which u is
// smallest (the first such), with u's component taken out.
__device__ void any_orthogonal(const double u[3], double w[3]) {
    int k = 0;
    if (fabs(u[1]) < fabs(u[k])) k = 1;
    if (fabs(u[2]) < fabs(u[k])) k = 2;
    double e[3] = {0.0, 0.0, 0.0};
    e[k] = 1.0;
    const double d = e[0] * u[0] + e[1] * u[1] + e[2] * u[2];
    double n = 0.0;
    for (int i = 0; i < 3; ++i) {
        w[i] = e[i] - d * u[i];
        n += w[i] * w[i];
    }
    n = sqrt(n);
    for (int i = 0; i < 3; ++i) w[i] /= n;
}

__global__ void __launch_bounds__(PROC_THREADS)
procrustes3_kernel(const float* __restrict__ S, float* __restrict__ R, int n,
                   unsigned long long* __restrict__ launches) {
    // The device's own count of launches, eager or inside a CUDA graph
    // (a profiler's trace does not attribute graph kernels reliably).
    if (launches != nullptr && blockIdx.x == 0 && threadIdx.x == 0) {
        atomicAdd(launches, 1ULL);
    }
    const int m = blockIdx.x * PROC_THREADS + threadIdx.x;
    if (m >= n) return;
    const float* s = S + (size_t)m * 9;
    float* r = R + (size_t)m * 9;

    double a[3][3];
    bool finite = true;
    for (int i = 0; i < 3; ++i) {
        for (int j = 0; j < 3; ++j) {
            const float x = s[3 * i + j];
            finite = finite && isfinite(x);
            a[i][j] = (double)x;
        }
    }
    if (!finite) {
        for (int k = 0; k < 9; ++k) r[k] = __int_as_float(0x7fc00000);
        return;
    }
    double v[3][3] = {{1.0, 0.0, 0.0}, {0.0, 1.0, 0.0}, {0.0, 0.0, 1.0}};

    const int P[3] = {0, 0, 1};
    const int Q[3] = {1, 2, 2};
    for (int sweep = 0; sweep < PROC_SWEEPS; ++sweep) {
#pragma unroll
        for (int k = 0; k < 3; ++k) {
            const int p = P[k], q = Q[k];
            double alpha = 0.0, beta = 0.0, gamma = 0.0;
            for (int i = 0; i < 3; ++i) {
                alpha += a[i][p] * a[i][p];
                beta += a[i][q] * a[i][q];
                gamma += a[i][p] * a[i][q];
            }
            if (fabs(gamma) <= PROC_EPS * sqrt(alpha * beta)) continue;
            // The rotation that makes columns p and q orthogonal: t the
            // smaller root of t^2 + 2 zeta t - 1 = 0.
            const double zeta = (beta - alpha) / (2.0 * gamma);
            const double t =
                copysign(1.0, zeta) / (fabs(zeta) + sqrt(1.0 + zeta * zeta));
            const double c = 1.0 / sqrt(1.0 + t * t);
            const double sn = c * t;
            for (int i = 0; i < 3; ++i) {
                const double ap = a[i][p], aq = a[i][q];
                a[i][p] = c * ap - sn * aq;
                a[i][q] = sn * ap + c * aq;
                const double vp = v[i][p], vq = v[i][q];
                v[i][p] = c * vp - sn * vq;
                v[i][q] = sn * vp + c * vq;
            }
        }
    }

    // Singular values: the columns' norms; the two largest first.
    double sig[3];
    for (int j = 0; j < 3; ++j) {
        sig[j] = sqrt(a[0][j] * a[0][j] + a[1][j] * a[1][j] +
                      a[2][j] * a[2][j]);
    }
    int i1 = 0;
    if (sig[1] > sig[i1]) i1 = 1;
    if (sig[2] > sig[i1]) i1 = 2;
    int i2 = i1 == 0 ? 1 : 0;
    for (int j = 0; j < 3; ++j) {
        if (j != i1 && sig[j] > sig[i2]) i2 = j;
    }

    double u1[3], u2[3], v1[3], v2[3], u3[3], w3[3];
    for (int i = 0; i < 3; ++i) {
        v1[i] = v[i][i1];
        v2[i] = v[i][i2];
    }
    if (sig[i1] > 0.0) {
        for (int i = 0; i < 3; ++i) u1[i] = a[i][i1] / sig[i1];
    } else {
        u1[0] = 1.0;
        u1[1] = 0.0;
        u1[2] = 0.0;
    }
    if (sig[i2] > 0.0) {
        // u2 = a2 / s2, made orthogonal to u1 again.
        double d = 0.0;
        for (int i = 0; i < 3; ++i) {
            u2[i] = a[i][i2] / sig[i2];
            d += u1[i] * u2[i];
        }
        double nrm = 0.0;
        for (int i = 0; i < 3; ++i) {
            u2[i] -= d * u1[i];
            nrm += u2[i] * u2[i];
        }
        nrm = sqrt(nrm);
        if (nrm > 0.0) {
            for (int i = 0; i < 3; ++i) u2[i] /= nrm;
        } else {
            any_orthogonal(u1, u2);
        }
    } else {
        any_orthogonal(u1, u2);
    }
    cross3(u1, u2, u3);
    cross3(v1, v2, w3);
    for (int i = 0; i < 3; ++i) {
        for (int j = 0; j < 3; ++j) {
            const double x = u1[i] * v1[j] + u2[i] * v2[j] + u3[i] * w3[j];
            r[3 * i + j] = __double2float_rn(x);
        }
    }
}

// Launches one thread per matrix on `stream`; returns cudaGetLastError().
// S and R hold n row-major 3x3 float32 matrices. `launches` (a device
// uint64, or null) gains one for every launch the device runs.
extern "C" int apds_procrustes3(const float* S, float* R, int n,
                                void* launches, void* stream) {
    if (n < 1 || !S || !R) return (int)cudaErrorInvalidValue;
    const int blocks = (n + PROC_THREADS - 1) / PROC_THREADS;
    procrustes3_kernel<<<blocks, PROC_THREADS, 0, (cudaStream_t)stream>>>(
        S, R, n, (unsigned long long*)launches);
    return (int)cudaGetLastError();
}
