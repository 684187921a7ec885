// Offset-diagonal (DIA) sparse matrix-vector product, hand-written for Hopper
// (sm_90a): y[r] = sum_k vals[k, r] * x[r + o_k], one launch per product.
//
// Replaces no TPU kernel: in the JAX package dia_matvec
// (ngsxfem_tpu/solvers/sparse.py) is jnp code, 27 shifted slices that XLA
// fuses into one loop.  The port ran it eagerly (solvers/sparse.py
// dia_matvec_plain): one pad, then a multiply and an add per offset, 54
// launches for the lattice's 27-offset table.  Inside the lattice solve
// (krylov.cg_ir on the flagship's table, some 600 products a step) that made
// the product launch-bound: ~490 us of host launches for a pass over 12.7 MB
// that the card's memory streams in ~4 us.
//
// What bounds it, and what the design does about it:
//   - The call is bound by its launch.  So it is one launch with everything
//     passed by value: the offsets travel in the kernel's parameter struct
//     (at most kMaxTerms = 32, the wrapper builds the struct once per offset
//     tuple and caches it), so there is no device offset array, no copy to
//     the card and nothing allocated here; the wrapper allocates y.
//   - The device work is bound by the table's bytes: each of the n_off
//     diagonals read once (n_off * n values), x read, y written.  One thread
//     per row: the vals[k, r] reads of a warp are 32 neighbouring values of
//     one diagonal (coalesced); x[r + o_k] goes through the read-only path
//     (__ldg), where a row's neighbours share its lines in L1 and L2.  The
//     offset loop is unrolled to kMaxTerms with a predicate, so every offset
//     is read from the parameter bank at a static index and the loads of one
//     thread's rows are independent of its sums.  No arithmetic worth
//     counting (2 flops per stored value); tensor cores, TMA and clusters
//     bring nothing to a stream this short.
//
// The sum is the eager path's, bit for bit: in table order, y = v0 * x0
// first (not 0 + v0 * x0), then each term as a separately rounded multiply
// and a separately rounded add (__fmul_rn / __fadd_rn, __dmul_rn /
// __dadd_rn: never a contracted FMA).  A column outside [0, n) reads +0 and
// is still multiplied, as the eager path multiplies its zero padding.  So
// signed zeros, infinities and NaNs come out where they do there (a NaN's
// payload may differ: nothing reads it).  The kernel launches on the
// caller's stream, on the current device, which the wrapper sets; it never
// synchronises, and the C entry returns the CUDA error of the launch, 0 on
// success.

#include <cuda_runtime.h>

constexpr int kMaxTerms = 32;

// The offsets, passed by value (its layout is the wrapper's ctypes struct).
struct DiaOffsets {
    long long off[kMaxTerms];
    int count;
};

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }

template <typename T>
__global__ void __launch_bounds__(kThreads)
dia_spmv_kernel(const T* __restrict__ vals, const T* __restrict__ x,
                T* __restrict__ y, long long n, DiaOffsets offs) {
    const long long r = (long long)blockIdx.x * kThreads + threadIdx.x;
    if (r >= n) return;
    T acc = T(0);
#pragma unroll
    for (int k = 0; k < kMaxTerms; ++k) {
        if (k < offs.count) {
            const long long c = r + offs.off[k];
            const T xv = (c >= 0 && c < n) ? __ldg(x + c) : T(0);
            const T v = vals[(long long)k * n + r];
            const T t = mul_rn(v, xv);
            acc = k == 0 ? t : add_rn(acc, t);
        }
    }
    y[r] = acc;
}

template <typename T>
int launch(const T* vals, const T* x, T* y, long long n, DiaOffsets offs,
           void* stream) {
    if (n < 0 || offs.count < 1 || offs.count > kMaxTerms)
        return static_cast<int>(cudaErrorInvalidValue);
    if (n == 0) return 0;
    const long long nb = (n + kThreads - 1) / kThreads;
    if (nb > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
    dia_spmv_kernel<T><<<(unsigned)nb, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        vals, x, y, n, offs);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* dia_spmv_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// y (n,) = the DIA product of the table vals (offs.count, n), row-major, and
// x (n,), all device memory of one dtype on the current device, launched on
// `stream`.  offs.off[:offs.count] are the diagonals' offsets, in table
// order.  Returns 0, or the CUDA error code of the launch.
int dia_spmv_f32(const float* vals, const float* x, float* y, long long n,
                 DiaOffsets offs, void* stream) {
    return launch<float>(vals, x, y, n, offs, stream);
}

int dia_spmv_f64(const double* vals, const double* x, double* y, long long n,
                 DiaOffsets offs, void* stream) {
    return launch<double>(vals, x, y, n, offs, stream);
}

}  // extern "C"
