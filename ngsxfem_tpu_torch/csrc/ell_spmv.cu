// Sliced-ELL (SELL-32-1024) sparse matrix-vector product, hand-written for
// Hopper (sm_90a):  y[r] = sum_{k < len(r)} vals[r, k] * x[cols[r, k]].
//
// Replaces the TPU kernel ngsxfem_tpu/solvers/sparse.py::
// ELLMatrix._matvec_pallas_impl (defined at sparse.py:158, pallas_call at
// sparse.py:179).  That kernel took (256, K) row tiles of cols and vals into
// VMEM, kept x whole in VMEM and reduced each row; on the TPU it never lowered
// and always fell back to the jnp gather.  It computes ELLMatrix.matvec, the
// operator of every general-mesh solve: Jacobi-CG on ELL, the default
// Inverse() of an SPD system on the card, MINRES, and every product of the
// functional cut multigrid (fine operator, restriction, prolongation and the
// interface block).
//
// Layout (built once per table by solvers/ell_spmv.py::prepare_ell).  A
// row's length is one past its last slot that is not padding (col 0, value
// +-0) in the reference's (n, K) table; no slot before that is dropped, so
// NaN values and explicit zeros stay in the sum.  Inside windows of 1024
// rows the rows are sorted by length, longest first (stable: rows of equal
// length keep their order); rows[p] is the table row at sorted position p.
// Sorted positions go in slices of 32.  Slice s is padded to its own longest
// row, slice_K[s] slots, and stored slot-major: lane l of slot k sits at
// slice_ptr[s] + 32*k + l (slice_ptr int64).  The sort is what keeps the
// padding small where short and long rows alternate (velocity and pressure
// rows of cut Stokes, active and inactive dofs of a fictitious domain):
// stored slots over real slots, the slice fill, printed by chip_smoke.py.
//
// Design.  One warp per slice, lane l on sorted position 32*s + l, in a
// grid-stride loop over slices.  For each slot the warp reads 32
// consecutive values (128 B in f32, 256 B in f64) and 32 consecutive
// columns (128 B): every load is coalesced.  Values and columns are read
// once per product, as streaming data (__ldcs, evict-first), so that L1 and
// L2 are left to x, which is gathered through the read-only path (__ldg).
// The slot loop runs in steps of 8 slots as a two-stage software pipeline:
// while x is gathered for the current 8 slots, the values and columns of
// the next 8 are already loading, and every load of a step is issued before
// its adds (a partial last step runs the same body under guards).  That
// takes a memory round trip off each step, which is what the small,
// latency-bound tables need.  The lane writes its sum to y[rows[p]], its
// row read at the start.  Each lane sums its row in the order
// k = 0..slice_K[s]-1 with __fmul_rn/__fadd_rn (__dmul_rn/__dadd_rn in
// f64), nothing FMA-contracted, so the result equals the plain PyTorch sum
// of ell_spmv.sell_matvec_plain bit for bit.  The slots it leaves out
// against the (n, K) table are trailing +-0 * x[0] terms: for finite x they
// change nothing but the sign of an all-zero row.  The kernel allocates
// nothing and launches on the caller's stream; the C entry returns the CUDA
// error of the launch, 0 on success.  Column indices are not checked here:
// ELLMatrix.from_numpy checks 0 <= cols < ncols once on the host.
//
// What bounds it on an H100.  Bytes: each real slot's value and int32
// column read once, x read once, y written once; 2 flops per slot.  At
// 0.25 flop/byte (f32) it is bound by memory traffic.  Besides those bytes
// the kernel reads the padding of its slices and rows (4 bytes a row).
//
// Tensor cores (wgmma), TMA and clusters bring nothing to a gather-bound
// product; they are not used.

#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;          // rows per slice = lanes per warp
constexpr int kThreads = 256;      // threads per block: 8 slices in flight
constexpr int kMaxBlocks = 65535;  // grid cap (grid-stride loop beyond it)
constexpr int kUnroll = 8;         // slots per unrolled step

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }

template <typename T>
__global__ void __launch_bounds__(kThreads)
sell32_spmv_kernel(int n, long long nslices,
                   const long long* __restrict__ slice_ptr,
                   const int* __restrict__ slice_K,
                   const int* __restrict__ rows,
                   const T* __restrict__ vals, const int* __restrict__ cols,
                   const T* __restrict__ x, T* __restrict__ y) {
    const int lane = threadIdx.x & (kWarp - 1);
    const long long first = ((long long)blockIdx.x * blockDim.x + threadIdx.x) / kWarp;
    const long long stride = ((long long)gridDim.x * blockDim.x) / kWarp;
    for (long long s = first; s < nslices; s += stride) {
        const long long p = s * kWarp + lane;
        const int row = p < n ? __ldcs(rows + p) : 0;
        const long long base = __ldg(slice_ptr + s) + lane;
        const int K = __ldg(slice_K + s);
        const T* v = vals + base;
        const int* c = cols + base;
        T vv[kUnroll] = {};
        int cc[kUnroll] = {};
#pragma unroll
        for (int j = 0; j < kUnroll; ++j) {
            if (j < K) {
                vv[j] = __ldcs(v + (long long)j * kWarp);
                cc[j] = __ldcs(c + (long long)j * kWarp);
            }
        }
        T acc = T(0);
        for (int k = 0; k < K; k += kUnroll) {
            T xx[kUnroll], nv[kUnroll] = {};
            int nc[kUnroll] = {};
#pragma unroll
            for (int j = 0; j < kUnroll; ++j)
                if (k + j < K) xx[j] = __ldg(x + cc[j]);
#pragma unroll
            for (int j = 0; j < kUnroll; ++j) {
                if (k + kUnroll + j < K) {
                    nv[j] = __ldcs(v + (long long)(k + kUnroll + j) * kWarp);
                    nc[j] = __ldcs(c + (long long)(k + kUnroll + j) * kWarp);
                }
            }
#pragma unroll
            for (int j = 0; j < kUnroll; ++j)
                if (k + j < K) acc = add_rn(acc, mul_rn(vv[j], xx[j]));
#pragma unroll
            for (int j = 0; j < kUnroll; ++j) {
                vv[j] = nv[j];
                cc[j] = nc[j];
            }
        }
        if (p < n) y[row] = acc;
    }
}

template <typename T>
int launch(const T* vals, const int* cols, const long long* slice_ptr,
           const int* slice_K, const int* rows, const T* x, T* y, int n,
           long long nslices, void* stream) {
    if (n < 0 || nslices != ((long long)n + kWarp - 1) / kWarp)
        return static_cast<int>(cudaErrorInvalidValue);
    if (n == 0) return 0;
    const long long per_block = kThreads / kWarp;
    long long nb = (nslices + per_block - 1) / per_block;
    if (nb > kMaxBlocks) nb = kMaxBlocks;
    sell32_spmv_kernel<T><<<(int)nb, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        n, nslices, slice_ptr, slice_K, rows, vals, cols, x, y);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* ell_spmv_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// y (n,) = SELL-32-1024 table times x.  Device memory: vals and cols
// (slots,) slot-major per slice, slice_ptr (nslices + 1,) int64, slice_K
// (nslices,) int32, rows (n,) int32 (table row of each sorted position), x
// (ncols,), y (n,) output; nslices = ceil(n / 32).  Returns 0, or the CUDA
// error code of the launch.
int sell_spmv_f32(const float* vals, const int* cols, const long long* slice_ptr,
                  const int* slice_K, const int* rows, const float* x, float* y,
                  int n, long long nslices, void* stream) {
    return launch<float>(vals, cols, slice_ptr, slice_K, rows, x, y, n, nslices,
                         stream);
}

int sell_spmv_f64(const double* vals, const int* cols, const long long* slice_ptr,
                  const int* slice_K, const int* rows, const double* x, double* y,
                  int n, long long nslices, void* stream) {
    return launch<double>(vals, cols, slice_ptr, slice_K, rows, x, y, n, nslices,
                          stream);
}

// What the compiler made of the two kernels, on the current device:
// info[0..2] = registers per thread, static shared memory bytes, local
// memory bytes per thread of the f32 kernel, info[3..5] those of the f64
// kernel.  Returns 0 or the CUDA error code.
int sell_spmv_kernel_info(int* info) {
    cudaFuncAttributes a{}, b{};
    cudaError_t e = cudaFuncGetAttributes(&a, sell32_spmv_kernel<float>);
    if (e == cudaSuccess) e = cudaFuncGetAttributes(&b, sell32_spmv_kernel<double>);
    if (e != cudaSuccess) return static_cast<int>(e);
    info[0] = a.numRegs;
    info[1] = static_cast<int>(a.sharedSizeBytes);
    info[2] = static_cast<int>(a.localSizeBytes);
    info[3] = b.numRegs;
    info[4] = static_cast<int>(b.sharedSizeBytes);
    info[5] = static_cast<int>(b.localSizeBytes);
    return 0;
}

}  // extern "C"
