// COO triplets to the padded (n, K) ELL table, sum and placement, hand-written
// for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package converts on the host
// (ngsxfem_tpu/solvers/sparse.py SparseMatrix.to_ell), and so did the port
// until this kernel.  It is the last step of solvers/coo_ell.py::coo_to_ell,
// which first sorts the keys row * ncols + col stably on the card
// (torch.sort), so that each run of equal keys, one unique entry, lies
// contiguous and in stream order; then finds the runs and, per row, the
// runs' range.
//
// One thread per unique entry u (a grid-stride loop):
//   - sum: vals[perm[j]] for j in [starts[u], starts[u + 1]), in that order
//     (stream order), added to 0.0 in f64 with __dadd_rn and rounded once to
//     the table's type: what np.bincount(inv, weights=vals).astype(dtype)
//     of the host conversion gives, bit for bit;
//   - slot: the runs of its row are u' in [row_ptr[r], row_ptr[r + 1]), at
//     most K of them; its slot is the number of those whose first stream
//     position first[u'] is smaller than its own, so each row's entries sit
//     in first-appearance order, as the host's stable argsort puts them;
//   - it writes cols[r * K + slot] and vals[r * K + slot].
// Every slot is written by one thread: no atomics, the same table on every
// run.  Positions are int64, so a stream past 2^31 triplets is correct.  The
// wrapper zeroes the table (padding col 0, value 0) and allocates
// everything; the kernel launches on the caller's stream and the C entry
// returns the CUDA error of the launch, 0 on success.
//
// What bounds it on an H100.  Bytes: the permutation and one gather of a
// value per triplet (16 B a triplet), the run starts, keys and first
// positions per unique entry, the table written once.  The slot count reads
// first[] of its row K times per entry, but the threads of a warp mostly
// share a row, so those reads are broadcasts from L1.  No arithmetic worth
// counting: it is bound by the gathers of vals[perm[j]], which land in no
// order.  Tensor cores, TMA and clusters bring nothing here.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 1 << 20;

__device__ __forceinline__ float round_to(double a, float*) { return __double2float_rn(a); }
__device__ __forceinline__ double round_to(double a, double*) { return a; }

template <typename T>
__global__ void __launch_bounds__(kThreads)
coo_ell_place_kernel(long long nu, long long ncols, int K,
                     const T* __restrict__ vals,
                     const long long* __restrict__ perm,
                     const long long* __restrict__ starts,
                     const long long* __restrict__ ukey,
                     const long long* __restrict__ first,
                     const long long* __restrict__ row_ptr,
                     int* __restrict__ out_cols, T* __restrict__ out_vals) {
    const long long stride = (long long)gridDim.x * blockDim.x;
    for (long long u = (long long)blockIdx.x * blockDim.x + threadIdx.x; u < nu;
         u += stride) {
        const long long s = __ldg(starts + u), e = __ldg(starts + u + 1);
        double acc = 0.0;
        for (long long j = s; j < e; ++j)
            acc = __dadd_rn(acc, (double)__ldg(vals + __ldg(perm + j)));
        const long long key = __ldg(ukey + u);
        const long long r = key / ncols;
        const long long mine = __ldg(first + u);
        const long long b = __ldg(row_ptr + r), c = __ldg(row_ptr + r + 1);
        int slot = 0;
        for (long long k = b; k < c; ++k) slot += __ldg(first + k) < mine;
        const long long at = r * K + slot;
        out_cols[at] = (int)(key - r * ncols);
        out_vals[at] = round_to(acc, (T*)nullptr);
    }
}

template <typename T>
int launch(const T* vals, const long long* perm, const long long* starts,
           const long long* ukey, const long long* first,
           const long long* row_ptr, int* out_cols, T* out_vals, long long nu,
           long long ncols, int K, void* stream) {
    if (nu < 0 || ncols <= 0 || K < 0) return static_cast<int>(cudaErrorInvalidValue);
    if (nu == 0) return 0;
    long long nb = (nu + kThreads - 1) / kThreads;
    if (nb > kMaxBlocks) nb = kMaxBlocks;
    coo_ell_place_kernel<T><<<(int)nb, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        nu, ncols, K, vals, perm, starts, ukey, first, row_ptr, out_cols, out_vals);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* coo_ell_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Sum and place the nu unique entries of a sorted triplet stream into the
// zeroed (n, K) table out_cols (int32) / out_vals, row-major.  Device memory:
// vals (T,) the triplets' values in stream order, perm (T,) int64 the stream
// position of each sorted triplet, starts (nu + 1,) int64 the sorted
// position where each run begins (starts[nu] = T), ukey (nu,) int64 each
// run's key row * ncols + col, first (nu,) int64 each run's first stream
// position, row_ptr (n + 1,) int64 the first run of each row.  Returns 0, or
// the CUDA error code of the launch.
int coo_ell_place_f32(const float* vals, const long long* perm,
                      const long long* starts, const long long* ukey,
                      const long long* first, const long long* row_ptr,
                      int* out_cols, float* out_vals, long long nu,
                      long long ncols, int K, void* stream) {
    return launch<float>(vals, perm, starts, ukey, first, row_ptr, out_cols,
                         out_vals, nu, ncols, K, stream);
}

int coo_ell_place_f64(const double* vals, const long long* perm,
                      const long long* starts, const long long* ukey,
                      const long long* first, const long long* row_ptr,
                      int* out_cols, double* out_vals, long long nu,
                      long long ncols, int K, void* stream) {
    return launch<double>(vals, perm, starts, ukey, first, row_ptr, out_cols,
                          out_vals, nu, ncols, K, stream);
}

}  // extern "C"
