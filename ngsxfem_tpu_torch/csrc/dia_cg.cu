// Fixed-budget Jacobi-PCG on a symmetric offset-diagonal (DIA) operator,
// hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel ngsxfem_tpu/solvers/pallas_cg.py::dia_cg_fused
// (pallas_call at pallas_cg.py:159).  It computes what that kernel computes:
// x0 = 0, the whole fixed iteration budget, only the main diagonal and the
// positive-offset diagonals read (a negative offset -o is applied as the
// transpose of diagonal +o, since the operator is symmetric), and it returns
// x and ||r||.
//
// Design.  The TPU kernel keeps the whole problem resident in one core's
// VMEM and shifts vectors with (R, L) plane rolls.  Neither carries over: one
// SM cannot hold the problem, and the plane roll is a TPU lane artifact.  Here
// vectors are indexed flat.  Row i of A p is the sum, over the offsets o in
// table order, of A[i, i+o] p[i+o] for 0 <= i+o < n, where
// A[i, i+o] = d_{|o|}[min(i, i+o)]; the bounds are checked explicitly.  The C
// entry dia_cg_f32 runs the whole loop as a fixed sequence of small kernels
// per iteration on the caller's stream:
//   1. symmetric SpMV, with a per-block partial sum of p.Ap;
//   2. one-block finalize of alpha = rz / p.Ap (guarding p.Ap == 0);
//   3. update of x, r, z = dinv r, with a per-block partial sum of r.z;
//   4. one-block finalize of beta = rz_new / rz (guarding rz == 0);
//   5. update of p;
// and at the end ||r||.  alpha, beta and rz stay in device memory: nothing is
// read back to the host inside the loop.  The kernels allocate nothing; the
// caller passes every buffer.
//
// Numbers.  f32 PCG on the cut system is sensitive to rounding: at nx=48 a
// first version with f32 dot products and contracted multiply-adds drifted
// from the plain PyTorch path by 9.4e-3 relative in 50 iterations (H100).
// So this kernel does the plain path's arithmetic exactly: products and sums
// in the plain path's order with no FMA contraction (__fmul_rn/__fadd_rn),
// and dot products accumulated in f64 from exact f32 products and rounded
// once to f32, as ngsxfem_tpu_torch/solvers/krylov.py::_vdot does.  The
// rounded dot no longer depends on the reduction order, so the iterates match
// the plain path bit for bit in practice.  Reductions use no atomics (fixed
// per-block partials, then a fixed one-block tree), so a run is bitwise
// repeatable.
//
// What bounds it on an H100.  At nx=48 (n = 117,649) one iteration touches
// the 14 upper diagonals (6.6 MB) and about ten vector passes (~4.7 MB):
// ~11 MB, which fits the 50 MB L2.  At this size the loop is expected to be
// bound by kernel launches and latency (6 launches per iteration, each over
// a grid that fills the card only partly), not by HBM bandwidth.  Making it
// fast (a CUDA graph, or one persistent cooperative kernel with grid-wide
// syncs) is left to later work; this version is the simple, correct one.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;     // threads per block of the vector kernels
constexpr int kFinThreads = 1024; // threads of the one-block finalize
constexpr int kMaxBlocks = 4096;  // grid cap (grid-stride loops beyond it)
constexpr int kMaxTerms = 32;     // offsets supported (3D P1 flagship: 27)

// scalar slots in device memory
enum { S_RZ = 0, S_ALPHA = 1, S_BETA = 2, S_RES = 3 };
// finalize modes
enum { F_RZ = 0, F_ALPHA = 1, F_BETA = 2, F_NORM = 3 };

// The operator's offsets in table order, each with the table row it reads:
// the main or the positive-offset diagonal of |o|.
struct DiaTerms {
    int n_terms;
    int rows[kMaxTerms];
    int offs[kMaxTerms];
};

int num_blocks(int n) {
    int nb = (n + kThreads - 1) / kThreads;
    if (nb > kMaxBlocks) nb = kMaxBlocks;
    return nb < 1 ? 1 : nb;
}

// Sum of v over the block, valid in thread 0.  Fixed order: warp shuffles,
// then the first warp over the per-warp sums.  blockDim.x is a multiple of 32.
__device__ __forceinline__ double block_sum(double v, double* sh) {
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    if (lane == 0) sh[warp] = v;
    __syncthreads();
    if (warp == 0) {
        v = (lane < (int)(blockDim.x >> 5)) ? sh[lane] : 0.0;
        for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    }
    return v;
}

// exact product of two floats, in double
__device__ __forceinline__ double dprod(float a, float b) {
    return (double)a * (double)b;
}

// x = 0, r = b, z = dinv r, p = z; partial r.z
__global__ void init_kernel(int n, const float* __restrict__ b,
                            const float* __restrict__ dinv, float* x, float* r,
                            float* z, float* p, double* part) {
    __shared__ double sh[32];
    double acc = 0.0;
    for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
         i += gridDim.x * blockDim.x) {
        const float ri = b[i];
        const float zi = __fmul_rn(dinv[i], ri);
        x[i] = 0.f;
        r[i] = ri;
        z[i] = zi;
        p[i] = zi;
        acc += dprod(ri, zi);
    }
    acc = block_sum(acc, sh);
    if (threadIdx.x == 0) part[blockIdx.x] = acc;
}

// Ap = A p from the main and upper diagonals; partial p.Ap
__global__ void spmv_kernel(int n, const float* __restrict__ vals, DiaTerms t,
                            const float* __restrict__ p, float* __restrict__ Ap,
                            double* part) {
    __shared__ double sh[32];
    double acc = 0.0;
    for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
         i += gridDim.x * blockDim.x) {
        float y = 0.f;
#pragma unroll
        for (int q = 0; q < kMaxTerms; ++q) {
            if (q < t.n_terms) {
                const int c = i + t.offs[q];  // column
                if (c >= 0 && c < n) {
                    // A[i, c] = d_{|o|}[min(i, c)] (symmetry for o < 0)
                    const float a = vals[(size_t)t.rows[q] * n + (c < i ? c : i)];
                    y = __fadd_rn(y, __fmul_rn(a, p[c]));
                }
            }
        }
        Ap[i] = y;
        acc += dprod(p[i], y);
    }
    acc = block_sum(acc, sh);
    if (threadIdx.x == 0) part[blockIdx.x] = acc;
}

// one block: sum the partials in a fixed order, round once to f32, and
// update the scalars
__global__ void finalize_kernel(int nparts, const double* __restrict__ part,
                                float* scal, int mode) {
    __shared__ double sh[32];
    double acc = 0.0;
    for (int j = threadIdx.x; j < nparts; j += blockDim.x) acc += part[j];
    acc = block_sum(acc, sh);
    if (threadIdx.x != 0) return;
    const float s = (float)acc;
    if (mode == F_RZ) {
        scal[S_RZ] = s;
    } else if (mode == F_ALPHA) {
        scal[S_ALPHA] = scal[S_RZ] / (s == 0.f ? 1.f : s);
    } else if (mode == F_BETA) {
        const float rz = scal[S_RZ];
        scal[S_BETA] = s / (rz == 0.f ? 1.f : rz);
        scal[S_RZ] = s;
    } else {
        scal[S_RES] = sqrtf(s);
    }
}

// x += alpha p, r -= alpha Ap, z = dinv r; partial r.z
__global__ void update_xrz_kernel(int n, const float* __restrict__ dinv,
                                  const float* __restrict__ p,
                                  const float* __restrict__ Ap,
                                  const float* __restrict__ scal, float* x,
                                  float* r, float* z, double* part) {
    __shared__ double sh[32];
    const float alpha = scal[S_ALPHA];
    double acc = 0.0;
    for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
         i += gridDim.x * blockDim.x) {
        x[i] = __fadd_rn(x[i], __fmul_rn(alpha, p[i]));
        const float ri = __fsub_rn(r[i], __fmul_rn(alpha, Ap[i]));
        const float zi = __fmul_rn(dinv[i], ri);
        r[i] = ri;
        z[i] = zi;
        acc += dprod(ri, zi);
    }
    acc = block_sum(acc, sh);
    if (threadIdx.x == 0) part[blockIdx.x] = acc;
}

// p = z + beta p
__global__ void update_p_kernel(int n, const float* __restrict__ z,
                                const float* __restrict__ scal, float* p) {
    const float beta = scal[S_BETA];
    for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
         i += gridDim.x * blockDim.x)
        p[i] = __fadd_rn(z[i], __fmul_rn(beta, p[i]));
}

// partial r.r
__global__ void rr_kernel(int n, const float* __restrict__ r, double* part) {
    __shared__ double sh[32];
    double acc = 0.0;
    for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
         i += gridDim.x * blockDim.x)
        acc += dprod(r[i], r[i]);
    acc = block_sum(acc, sh);
    if (threadIdx.x == 0) part[blockIdx.x] = acc;
}

}  // namespace

extern "C" {

// Number of doubles the caller must provide in `partials` for size n.
int dia_cg_f32_num_partials(int n) { return num_blocks(n); }

const char* dia_cg_f32_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Fixed-budget Jacobi-PCG, x0 = 0.  Device memory:
//   vals (n_off, n) f32 row-major diagonal table; b, dinv (n,) f32 inputs;
//   x (n,) f32 output; r, z, p, Ap (n,) f32 scratch;
//   partials (num_partials(n),) f64 scratch; scal (4,) f32 scalars,
//   scal[3] = ||r|| on return.
// rows/offs are HOST arrays of n_terms ints: the offsets in table order and,
// for each, the table row holding diagonal |o|.
// Returns 0, or the CUDA error code of the first launch that failed.
int dia_cg_f32(const float* vals, int n, int n_terms, const int* rows,
               const int* offs, const float* b, const float* dinv, int iters,
               float* x, float* r, float* z, float* p, float* Ap,
               double* partials, float* scal, void* stream) {
    if (n <= 0 || iters < 0 || n_terms < 0 || n_terms > kMaxTerms)
        return static_cast<int>(cudaErrorInvalidValue);
    DiaTerms t;
    t.n_terms = n_terms;
    for (int q = 0; q < kMaxTerms; ++q) {
        t.rows[q] = q < n_terms ? rows[q] : 0;
        t.offs[q] = q < n_terms ? offs[q] : 0;
    }
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int nb = num_blocks(n);
    cudaError_t e;
#define CHECK_LAUNCH()                        \
    do {                                      \
        e = cudaGetLastError();               \
        if (e != cudaSuccess) return (int)e;  \
    } while (0)

    init_kernel<<<nb, kThreads, 0, s>>>(n, b, dinv, x, r, z, p, partials);
    CHECK_LAUNCH();
    finalize_kernel<<<1, kFinThreads, 0, s>>>(nb, partials, scal, F_RZ);
    CHECK_LAUNCH();
    for (int it = 0; it < iters; ++it) {
        spmv_kernel<<<nb, kThreads, 0, s>>>(n, vals, t, p, Ap, partials);
        CHECK_LAUNCH();
        finalize_kernel<<<1, kFinThreads, 0, s>>>(nb, partials, scal, F_ALPHA);
        CHECK_LAUNCH();
        update_xrz_kernel<<<nb, kThreads, 0, s>>>(n, dinv, p, Ap, scal, x, r, z,
                                                  partials);
        CHECK_LAUNCH();
        finalize_kernel<<<1, kFinThreads, 0, s>>>(nb, partials, scal, F_BETA);
        CHECK_LAUNCH();
        update_p_kernel<<<nb, kThreads, 0, s>>>(n, z, scal, p);
        CHECK_LAUNCH();
    }
    rr_kernel<<<nb, kThreads, 0, s>>>(n, r, partials);
    CHECK_LAUNCH();
    finalize_kernel<<<1, kFinThreads, 0, s>>>(nb, partials, scal, F_NORM);
    CHECK_LAUNCH();
#undef CHECK_LAUNCH
    return 0;
}

}  // extern "C"
