// The port's ELL kernel before the sliced layout: csrc/ell_spmv.cu as of
// commit d41764a, unchanged below this note.  tools/torch_ell_spmv_before_after.py
// and chip_smoke.py build it beside the current kernel and time both on the
// same tables in one process ("before" against "after").
//
// Row-padded ELL sparse matrix-vector product, hand-written for Hopper
// (sm_90a):  y[r] = sum_{k=0}^{K-1} vals[r, k] * x[cols[r, k]].
//
// Replaces the TPU kernel ngsxfem_tpu/solvers/sparse.py::
// ELLMatrix._matvec_pallas_impl (defined at sparse.py:158, pallas_call at
// sparse.py:179).  That kernel took (256, K) row tiles of cols and vals into
// VMEM, kept x whole in VMEM and reduced each row; on the TPU it never lowered
// and always fell back to the jnp gather.  It computes ELLMatrix.matvec, the
// operator of every general-mesh solve: Jacobi-CG on ELL and every product of
// the functional cut multigrid (fine operator, restriction, prolongation and
// the interface block).
//
// Design.  One thread per row over the reference's row-major (n, K) layout.
// The row sum runs in the fixed order k = 0..K-1 with __fmul_rn/__fadd_rn
// (__dmul_rn/__dadd_rn in f64), so nothing is FMA-contracted and the result
// equals the plain PyTorch loop
//     y = 0; for k: y = y + vals[:, k] * x[cols[:, k]]
// bit for bit.  x is read through the read-only data path (__ldg).  Padding
// slots keep the reference's meaning (col 0, val 0) and are summed like any
// other slot.  The kernel allocates nothing and launches on the caller's
// stream; the C entry returns the CUDA error of the launch, 0 on success.
// Column indices are not checked here: ELLMatrix.from_numpy checks
// 0 <= cols < ncols once on the host.
//
// What bounds it on an H100.  Each input read once and the output written
// once: n*K*(4 + s) + n*s + n*s bytes for values of s bytes.  At the flagship
// nx=48 in f32 (n = 117,649, K = 25) that is about 24.5 MB, so about 7.3 us at
// 3.35 TB/s; the 2*n*K flops take under 0.1 us at 67 TFLOP/s.  It is bound by
// memory traffic.
//
// What this simple design leaves on the table.  Neighbouring threads read
// rows K elements apart, so each warp's loads of cols and vals are
// uncoalesced (32 rows x 4 bytes spread over 32 x K x 4 bytes) and every
// sector fetched is used only partly per instruction; L1 reuse recovers some
// of it.  A column-major (K, n) layout or a sliced ELL (rows in slices of 32,
// slot-major inside a slice) would make the loads coalesced; both change the
// table's layout and are later work.  At nx=48 the whole problem (24.5 MB)
// fits the 50 MB L2, so repeated calls may run from L2.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;      // threads per block
constexpr int kMaxBlocks = 65535;  // grid cap (grid-stride loop beyond it)

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }

template <typename T>
__global__ void ell_spmv_kernel(int n, int K, const T* __restrict__ vals,
                                const int* __restrict__ cols,
                                const T* __restrict__ x, T* __restrict__ y) {
    for (long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x; r < n;
         r += (long long)gridDim.x * blockDim.x) {
        const T* v = vals + r * K;
        const int* c = cols + r * K;
        T acc = T(0);
        for (int k = 0; k < K; ++k)
            acc = add_rn(acc, mul_rn(v[k], __ldg(x + c[k])));
        y[r] = acc;
    }
}

template <typename T>
int launch(const T* vals, const int* cols, const T* x, T* y, int n, int K,
           void* stream) {
    if (n < 0 || K < 0) return static_cast<int>(cudaErrorInvalidValue);
    if (n == 0) return 0;
    long long nb = ((long long)n + kThreads - 1) / kThreads;
    if (nb > kMaxBlocks) nb = kMaxBlocks;
    ell_spmv_kernel<T><<<(int)nb, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        n, K, vals, cols, x, y);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* ell_spmv_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// y (n,) = ELL (n, K) times x.  Device memory: vals (n, K) row-major, cols
// (n, K) int32 row-major, x (ncols,), y (n,) output.  Returns 0, or the CUDA
// error code of the launch.
int ell_spmv_f32(const float* vals, const int* cols, const float* x, float* y,
                 int n, int K, void* stream) {
    return launch<float>(vals, cols, x, y, n, K, stream);
}

int ell_spmv_f64(const double* vals, const int* cols, const double* x,
                 double* y, int n, int K, void* stream) {
    return launch<double>(vals, cols, x, y, n, K, stream);
}

}  // extern "C"
