// Fixed-budget Jacobi-PCG on a symmetric offset-diagonal (DIA) operator,
// hand-written for Hopper (sm_90a) as ONE persistent cooperative kernel.
//
// Replaces the TPU kernel ngsxfem_tpu/solvers/pallas_cg.py::dia_cg_fused
// (defined at pallas_cg.py:86, pallas_call at pallas_cg.py:159).  It computes
// what that kernel computes: x0 = 0, the whole fixed iteration budget, only the
// main diagonal and the positive-offset diagonals read (a negative offset -m is
// applied as the transpose of diagonal +m: A[i, i+o] = d_|o|[min(i, i+o)]),
// and it returns x and ||r||.
//
// What bounds it on an H100.  At the flagship nx=48 (n = 117,649, 27 offsets)
// one iteration is a 27-term SpMV, ten vector passes and two dot products:
// under 1 us of device work.  But each dot product is a reduction over the
// whole grid that the next step needs, so an iteration holds two grid-wide
// dependencies.  As separate kernels they would be five launches per
// iteration (254 dependent launches per PCG-50 call, ~4 us each); this
// kernel pays for them inside one launch and is bound by latency, not by
// bytes or flops: two exchanges of partial sums through L2 per iteration (~2 us each
// over 115 blocks on an H100 SXM), the load of the p window's halo from L2
// (~4.9 MB per iteration over the grid) and the SpMV's shared-memory traffic.
//
// Design (the TPU kernel's idea, the operator and the Krylov vectors resident
// on chip for the whole loop, spread over the SMs' shared memory):
// - Cooperative launch of `grid` blocks, at most one per SM, all co-resident;
//   each block owns the contiguous rows [s, s + chunk).  The launch plan
//   (rows per block, what is staged) is made on the host by
//   solvers/dia_cg.py::_plan; the C entry checks it and the co-residency, and
//   returns an error code instead of launching a plan that cannot run.
// - At kernel start a block copies into dynamic shared memory, as far as the
//   plan's budget goes: its p window [s - halo, e + halo) (p_k is rebuilt in
//   place there each iteration, zero outside [0, n)), its rows of x, r, dinv
//   and Ap, and the coefficients of its rows term by term, aligned to the row
//   (coef[slot][i - s] = A[i, i + o], zero where i + o is outside [0, n)).
//   What is not staged is read from global memory in the same kernel:
//   coefficients from the table, p at columns outside the window recomputed
//   from z_k and p_{k-1}, the vectors from their global buffers.  At nx=48
//   everything is staged; the table is then read from shared memory in every
//   iteration and the SpMV needs no bounds check (the kFull instance).
// - Two grid-wide exchanges per iteration, and no atomics: every block
//   publishes one f64 partial per dot product; the first warp of block 0
//   gathers them, sums them in one fixed order, and publishes alpha (or
//   beta), which every block waits for.  A partial travels as two 64-bit
//   words, its low and high half each beside the 32-bit tag of the exchange,
//   and alpha or beta as one word, its f32 bits beside the tag; a 64-bit
//   store is single-copy atomic, so a reader that sees the tag has the value.
//   A release fence before a publication and an acquire fence after the wait
//   make global writes cross (z, and p where a window is partial); with
//   everything staged only z crosses, and each block waits directly for the
//   blocks its window covers.  The schedule of iteration k:
//     1. p_k on the window: p_0 = z_0 = dinv*b from the inputs, then
//        p_k[c] = z_k[c] + beta_{k-1} p_{k-1}[c] (z_k from global memory,
//        p_{k-1} already in the window), bitwise what the owner of c computes;
//     2. Ap = A p_k on the block's rows, its rows of p_k to the parity buffer
//        P[k & 1] (only where some window is partial), partial p.Ap;
//     exchange A (tag t0 + 1 + 2k): alpha = rz_k / sum(p.Ap);
//     3. x += alpha p, r -= alpha Ap, z_{k+1} = dinv r (z to global memory),
//        partials r.z and r.r;
//     exchange B (tag t0 + 2 + 2k): beta_k = sum(r.z) / rz_k.  While the
//        first warp waits for beta, the others wait for the blocks the window
//        covers and load z_{k+1} on it: step 1 of k+1 needs only beta then.
//   The last iteration skips exchange B's beta; block 0 gathers r.r for ||r||.
//   Why nothing is read while its owner may still write it: z_{k+1} is
//   written in step 3, after exchange A(k), and read by other blocks after
//   they saw the writer's B(k) partial; its previous value z_k was read in
//   steps 1 and 2 of k, before the reader published A(k), and block 0 sends
//   alpha(k) only after every A(k).  P[k & 1] is written in step 2 of k; the
//   value it overwrites, p_{k-2}, was last read in step 2 of k-1, before
//   A(k-1).  A block's slot of A is rewritten in step 2 of k+1, after beta(k),
//   which block 0 sends after it gathered every B(k), hence after it had
//   read every A(k); likewise for B and for the words of alpha and beta.  The
//   slot of r0.z0 (tag t0) is written once per call; the slot of r.r before
//   each B and read once, by block 0 after the last exchange.  The host gives
//   each call tags above those of the previous call on the same exchange
//   buffer, so a stale word never carries an expected tag.
// - The cooperative launch guarantees the co-residency that makes the spin
//   safe; a spin that lasts ~10 s traps instead of hanging the card.
//
// Numbers.  f32 PCG on the cut system is sensitive to rounding: at nx=48 a
// first version with f32 dot products and contracted multiply-adds drifted
// from the plain PyTorch path by 9.4e-3 relative in 50 iterations (H100).  So
// this kernel does the plain path's arithmetic exactly: SpMV terms in table
// order and every update with __fmul_rn/__fadd_rn/__fsub_rn (no FMA
// contraction), dot products accumulated in f64 from exact f32 products and
// rounded once to f32, as ngsxfem_tpu_torch/solvers/krylov.py::_vdot does.
// The rounded dot no longer depends on the reduction order, so the iterates
// match the plain path bit for bit in practice.  There are no atomics in the
// arithmetic, so a run is bitwise repeatable.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;  // threads per block (the plan may use fewer)
constexpr int kMaxTerms = 32;   // offsets supported (3D P1 flagship: 27)
constexpr int kMaxGrid = 1024;  // blocks (slots of the exchange buffer)
constexpr int kUnroll = 12;     // window loads in flight per thread
constexpr int kGroup = 8;       // SpMV terms whose loads are in flight at once
constexpr long long kSpinCycles = 1LL << 34;  // ~10 s at the H100's clock

// exchange buffer: four regions of kMaxGrid slots of two 64-bit words, then
// the words of alpha and beta
enum { X_A = 0, X_B = 1, X_R = 2, X_Z = 3, X_REGIONS = 4 };
constexpr int kAlphaWord = 2 * X_REGIONS * kMaxGrid;
constexpr int kBetaWord = kAlphaWord + 1;
// plan errors (CUDA errors are positive)
enum { E_PLAN = -1, E_NO_COOP = -2, E_NOT_RESIDENT = -3, E_SMEM = -4 };

struct Plan {
    int n, iters, n_terms;
    int chunk;      // rows per block
    int halo;       // staged p window: [s - halo, e + halo)
    int win;        // floats of shared memory for the window, 0: no window
    int stage_vec;  // x, r, dinv, Ap of the block's rows in shared memory
    int n_slots;    // coefficient slices in shared memory
    unsigned int tag0;    // tag of the first exchange of this call
    int rows[kMaxTerms];  // table row read by each term (main or upper)
    int offs[kMaxTerms];  // offset of each term, in table order
    int slot[kMaxTerms];  // shared-memory slot of each term, or -1
};

struct Bufs {
    const float* vals;
    const float* b;
    const float* dinv;
    float* x;
    float* r;
    float* z;
    float* Ap;
    float* P;                  // (2, n): p by iteration parity
    unsigned long long* xch;   // (X_REGIONS, kMaxGrid, 2) exchange words
    float* res;                // ||r||
};

// Phase stamps for tools/torch_dia_cg_phases.py: built with
// -DDIA_CG_PHASE_STAMPS, thread 0 of every block writes the global timer (ns)
// at five points of each of the first 64 iterations into stamps[k][ph][block]
// (set by dia_cg_f32_set_stamps).  Otherwise STAMP is empty.
#ifdef DIA_CG_PHASE_STAMPS
__device__ unsigned long long* g_stamps;
#define STAMP(ph)                                                          \
    do {                                                                   \
        if (threadIdx.x == 0 && k < 64) {                                  \
            unsigned long long t_;                                         \
            asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_));         \
            g_stamps[((size_t)k * 8 + (ph)) * gridDim.x + blockIdx.x] = t_; \
        }                                                                  \
    } while (0)
#else
#define STAMP(ph) \
    do {          \
    } while (0)
#endif

// exact product of two floats, in double
__device__ __forceinline__ double dprod(float a, float b) {
    return (double)a * (double)b;
}

__device__ __forceinline__ void fence_acq_rel() {
    asm volatile("fence.acq_rel.gpu;" ::: "memory");
}

__device__ __forceinline__ void st_relaxed(unsigned long long* p,
                                           unsigned long long v) {
    asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v)
                 : "memory");
}

__device__ __forceinline__ unsigned long long ld_relaxed(
    const unsigned long long* p) {
    unsigned long long v;
    asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p)
                 : "memory");
    return v;
}

// Sums of u and v over the block, valid in thread 0.  Fixed order: warp
// shuffles, then the first warp over the per-warp sums.  `sh` (64 doubles)
// must not be in use by another reduction still being read.
__device__ __forceinline__ void block_sum2(double& u, double& v, double* sh) {
    for (int o = 16; o > 0; o >>= 1) {
        u += __shfl_down_sync(0xffffffffu, u, o);
        v += __shfl_down_sync(0xffffffffu, v, o);
    }
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    if (lane == 0) {
        sh[warp] = u;
        sh[32 + warp] = v;
    }
    __syncthreads();
    if (warp == 0) {
        const int nw = (int)(blockDim.x >> 5);
        u = lane < nw ? sh[lane] : 0.0;
        v = lane < nw ? sh[32 + lane] : 0.0;
        for (int o = 16; o > 0; o >>= 1) {
            u += __shfl_down_sync(0xffffffffu, u, o);
            v += __shfl_down_sync(0xffffffffu, v, o);
        }
    }
}

// Publish v in a slot (two words) under `tag`.  The caller fences first.
__device__ __forceinline__ void put(unsigned long long* w, double v,
                                    unsigned int tag) {
    const unsigned long long bits = (unsigned long long)__double_as_longlong(v);
    const unsigned long long t = (unsigned long long)tag << 32;
    st_relaxed(w, t | (bits & 0xffffffffull));
    st_relaxed(w + 1, t | (bits >> 32));
}

// Block 0 broadcasts alpha and beta: one word, the f32 bits beside the tag.
__device__ __forceinline__ void put_scalar(unsigned long long* w, float v,
                                           unsigned int tag) {
    st_relaxed(w, ((unsigned long long)tag << 32) | __float_as_uint(v));
}

__device__ __forceinline__ float get_scalar(const unsigned long long* w,
                                            unsigned int tag) {
    const long long t0 = clock64();
    unsigned long long v;
    while ((unsigned int)((v = ld_relaxed(w)) >> 32) != tag)
        if (clock64() - t0 > kSpinCycles) __trap();
    return __uint_as_float((unsigned int)v);
}

// Gather, by the first warp of block 0: lane l waits for the slots l,
// l + 32, ... of region `ra` (and `rb`, if given), with all of a pass's
// loads in flight, adds them in that order, and an xor butterfly finishes
// the sums (the same in every lane).  With `acquire`, a fence then orders
// the block's later reads after the publishers' writes.
__device__ __forceinline__ void gather(const unsigned long long* xch, int ra,
                                       unsigned int ta, int rb,
                                       unsigned int tb, double& u, double& v,
                                       bool acquire) {
    constexpr int kPer = 4;  // slots per lane per pass
    const int lane = (int)threadIdx.x;
    const int G = (int)gridDim.x;
    const unsigned long long* wa = xch + 2 * (size_t)ra * kMaxGrid;
    const unsigned long long* wb = xch + 2 * (size_t)(rb < 0 ? ra : rb) * kMaxGrid;
    const long long t0 = clock64();
    u = 0.0;
    v = 0.0;
    for (int j0 = 0; j0 < G; j0 += 32 * kPer) {
        double au[kPer], bv[kPer];
        for (;;) {
            bool ok = true;
#pragma unroll
            for (int m = 0; m < kPer; ++m) {
                const int j = j0 + lane + 32 * m;
                au[m] = 0.0;
                bv[m] = 0.0;
                if (j < G) {
                    const unsigned long long lo = ld_relaxed(wa + 2 * j);
                    const unsigned long long hi = ld_relaxed(wa + 2 * j + 1);
                    ok = ok && (unsigned int)(lo >> 32) == ta &&
                         (unsigned int)(hi >> 32) == ta;
                    au[m] = __longlong_as_double(
                        (long long)((hi << 32) | (lo & 0xffffffffull)));
                    if (rb >= 0) {
                        const unsigned long long lo2 = ld_relaxed(wb + 2 * j);
                        const unsigned long long hi2 = ld_relaxed(wb + 2 * j + 1);
                        ok = ok && (unsigned int)(lo2 >> 32) == tb &&
                             (unsigned int)(hi2 >> 32) == tb;
                        bv[m] = __longlong_as_double(
                            (long long)((hi2 << 32) | (lo2 & 0xffffffffull)));
                    }
                }
            }
            if (__all_sync(0xffffffffu, ok)) break;
            if (clock64() - t0 > kSpinCycles) __trap();
        }
#pragma unroll
        for (int m = 0; m < kPer; ++m) {
            u += au[m];
            v += bv[m];
        }
    }
    if (acquire) fence_acq_rel();
    for (int o = 16; o > 0; o >>= 1) {
        u += __shfl_xor_sync(0xffffffffu, u, o);
        v += __shfl_xor_sync(0xffffffffu, v, o);
    }
}

template <bool kFull>
__global__ void __launch_bounds__(kThreads, 1)
dia_cg_kernel(const Plan pl, const Bufs bf) {
    extern __shared__ float smem[];
    // one reduction buffer per block reduction, so that neither overwrites
    // what the other is still reading: 0 p.Ap, 1 r.z/r.r
    __shared__ double sh[2][64];
    __shared__ float s_alpha, s_beta, s_rz;

    const int n = pl.n;
    const int R = pl.chunk;
    const int T = (int)blockDim.x;
    const int tid = (int)threadIdx.x;
    const int blk = (int)blockIdx.x;
    const int s = blk * R;
    const int nr = min(n, s + R) - s;  // the block's rows, >= 1 by the plan
    const int halo = pl.halo;
    // window [wlo, whi), pw[c - wlo]; empty when there is none
    const int wlo = pl.win ? s - halo : 0;
    const int whi = pl.win ? s + nr + halo : 0;
    const int wl = whi - wlo;

    // shared memory: [x r dinv Ap] (4R, if staged) [coef] (n_slots R) [window]
    float* sv = smem;
    float* coef = smem + (pl.stage_vec ? 4 * R : 0);
    float* pw = coef + pl.n_slots * R;
    float* xv = pl.stage_vec ? sv : bf.x + s;
    float* rv = pl.stage_vec ? sv + R : bf.r + s;
    const float* dv = pl.stage_vec ? sv + 2 * R : bf.dinv + s;
    float* av = pl.stage_vec ? sv + 3 * R : bf.Ap + s;

    const float* __restrict__ vals = bf.vals;
    const float* __restrict__ b = bf.b;
    const float* __restrict__ dinv = bf.dinv;
    float* z = bf.z;
    unsigned long long* xch = bf.xch;
    unsigned long long* my_slot = xch + 2 * (size_t)blk;  // + region offset

    // x = 0, r = b, partials of r0.z0 (z0 = dinv b) and r0.r0; stage the
    // block's coefficients
    double rz = 0.0, rr = 0.0;
    for (int li = tid; li < nr; li += T) {
        const float bi = b[s + li];
        const float di = dinv[s + li];
        xv[li] = 0.f;
        rv[li] = bi;
        if (pl.stage_vec) sv[2 * R + li] = di;
        rz += dprod(bi, __fmul_rn(di, bi));
        rr += dprod(bi, bi);
    }
    for (int q = 0; q < pl.n_terms; ++q) {
        const int sl = pl.slot[q];
        if (sl < 0) continue;
        const int o = pl.offs[q];
        const float* d = vals + (size_t)pl.rows[q] * n;
        for (int li = tid; li < nr; li += T) {
            const int i = s + li;
            const int c = i + o;
            coef[sl * R + li] = (c >= 0 && c < n) ? d[min(i, c)] : 0.f;
        }
    }
    block_sum2(rz, rr, sh[1]);
    if (tid == 0) {
        put(my_slot + 2 * (size_t)X_Z * kMaxGrid, rz, pl.tag0);
        put(my_slot + 2 * (size_t)X_R * kMaxGrid, rr, pl.tag0);
    }

    // The window's p from the loaded z, in place over p_{k-1}: p_0 = z_0,
    // p_k = z_k + beta p_{k-1}, and zero outside [0, n).
    auto combine = [&](float zc, int j, int kk, float bt) -> float {
        const int c = wlo + j;
        return (kk == 0 || c < 0 || c >= n) ? zc
                                            : __fadd_rn(zc, __fmul_rn(bt, pw[j]));
    };
    auto load_z = [&](int j, int kk) -> float {
        const int c = wlo + j;
        if (j >= wl || c < 0 || c >= n) return 0.f;
        return kk == 0 ? __fmul_rn(__ldg(dinv + c), __ldg(b + c)) : __ldcg(z + c);
    };
    // p_kk on window positions jstart + tid, + T, ...
    auto build_window = [&](int kk, float bt, int jstart) {
        for (int j0 = jstart + tid; j0 < wl; j0 += kUnroll * T) {
            float zc[kUnroll];
#pragma unroll
            for (int u = 0; u < kUnroll; ++u) zc[u] = load_z(j0 + u * T, kk);
#pragma unroll
            for (int u = 0; u < kUnroll; ++u) {
                const int j = j0 + u * T;
                if (j < wl) pw[j] = combine(zc[u], j, kk, bt);
            }
        }
    };

    // 1. (k = 0) p_0 on the window; later windows are built at the end of
    // the iteration before, with their loads in flight during exchange B
    build_window(0, 0.f, 0);
    float beta = 0.f;
    for (int k = 0; k < pl.iters; ++k) {
        const unsigned int tag_a = pl.tag0 + 1u + 2u * (unsigned int)k;
        const unsigned int tag_b = tag_a + 1u;
        const float* Pprev = bf.P + (size_t)((k + 1) & 1) * n;  // p_{k-1}
        float* Pk = bf.P + (size_t)(k & 1) * n;
        // p_k at a column outside the window, from global memory
        auto p_fly = [&](int c) -> float {
            if (k == 0) return __fmul_rn(__ldg(dinv + c), __ldg(b + c));
            return __fadd_rn(__ldcg(z + c), __fmul_rn(beta, __ldcg(Pprev + c)));
        };
        __syncthreads();  // the window holds p_k
        STAMP(1);

        // 2. Ap = A p_k on the block's rows; partial p.Ap
        double pap = 0.0, unused = 0.0;
        for (int li = tid; li < nr; li += T) {
            const int i = s + li;
            float y = 0.f;
            float pi;
            if (kFull) {
                // every coefficient staged (zero off the matrix) and the
                // window zero-padded: no bounds checks
                const float* pb = pw + halo + li;
#pragma unroll
                for (int q = 0; q < kMaxTerms; ++q)
                    if (q < pl.n_terms)
                        y = __fadd_rn(y, __fmul_rn(coef[q * R + li],
                                                   pb[pl.offs[q]]));
                pi = pb[0];
            } else {
                // terms in groups of kGroup: every load of a group is issued
                // before the first of its products, so a row waits for L2
                // once per group and not once per term
#pragma unroll
                for (int q0 = 0; q0 < kMaxTerms; q0 += kGroup) {
                    if (q0 < pl.n_terms) {
                        float a[kGroup], pc[kGroup];
#pragma unroll
                        for (int u = 0; u < kGroup; ++u) {
                            const int q = q0 + u;
                            a[u] = 0.f;
                            pc[u] = 0.f;
                            if (q < pl.n_terms) {
                                int c = i + pl.offs[q];
                                if (c < 0 || c >= n) c = i;  // term skipped below
                                const int sl = pl.slot[q];
                                // A[i, c] = d_{|o|}[min(i, c)] (symmetry, o < 0)
                                a[u] = sl >= 0 ? coef[sl * R + li]
                                               : __ldg(vals + (size_t)pl.rows[q] * n +
                                                       min(i, c));
                                pc[u] = (c >= wlo && c < whi) ? pw[c - wlo]
                                                              : p_fly(c);
                            }
                        }
#pragma unroll
                        for (int u = 0; u < kGroup; ++u) {
                            const int q = q0 + u;
                            const int c = i + pl.offs[q];
                            if (q < pl.n_terms && c >= 0 && c < n)
                                y = __fadd_rn(y, __fmul_rn(a[u], pc[u]));
                        }
                    }
                }
                pi = pl.win ? pw[halo + li] : p_fly(i);
                Pk[i] = pi;  // read by blocks whose window misses row i
            }
            av[li] = y;
            pap += dprod(pi, y);
        }
        block_sum2(pap, unused, sh[0]);
        STAMP(2);
        // exchange A.  With everything staged no global data crosses here,
        // only the partials, so no fences (kFull).
        if (tid == 0) {
            if (!kFull) fence_acq_rel();
            put(my_slot + 2 * (size_t)X_A * kMaxGrid, pap, tag_a);
        }
        if (tid < 32) {
            if (blk == 0) {
                double den, rz0;
                gather(xch, X_A, tag_a, k == 0 ? X_Z : -1, pl.tag0, den, rz0,
                       !kFull);
                if (tid == 0) {
                    if (k == 0) s_rz = (float)rz0;
                    const float d = (float)den;
                    s_alpha = s_rz / (d == 0.f ? 1.f : d);
                    if (!kFull) fence_acq_rel();
                    put_scalar(xch + kAlphaWord, s_alpha, tag_a);
                }
            } else if (tid == 0) {
                s_alpha = get_scalar(xch + kAlphaWord, tag_a);
                if (!kFull) fence_acq_rel();
            }
        }
        __syncthreads();
        const float alpha = s_alpha;
        STAMP(3);

        // 3. x += alpha p, r -= alpha Ap, z = dinv r
        double rzp = 0.0, rrp = 0.0;
        for (int li = tid; li < nr; li += T) {
            const float pi = pl.win ? pw[halo + li] : __ldcg(Pk + s + li);
            xv[li] = __fadd_rn(xv[li], __fmul_rn(alpha, pi));
            const float ri = __fsub_rn(rv[li], __fmul_rn(alpha, av[li]));
            const float zi = __fmul_rn(dv[li], ri);
            rv[li] = ri;
            z[s + li] = zi;
            rzp += dprod(ri, zi);
            rrp += dprod(ri, ri);
        }
        block_sum2(rzp, rrp, sh[1]);
        STAMP(4);
        if (tid == 0) {
            fence_acq_rel();
            put(my_slot + 2 * (size_t)X_R * kMaxGrid, rrp, tag_b);
            put(my_slot + 2 * (size_t)X_B * kMaxGrid, rzp, tag_b);
        }
        if (k + 1 == pl.iters) break;  // the last beta is not needed

        // exchange B, and 1. for k + 1: the first warp waits for beta (block
        // 0's first warp gathers every block's r.z and publishes it);
        // meanwhile the other warps wait only for the blocks whose rows the
        // window covers (their z_{k+1} is then visible) and load z_{k+1} on
        // the window, to combine with beta once it is known
        float zc[kUnroll];
        const int T1 = T - 32;
        if (tid < 32) {
            if (blk == 0) {
                double rzn, unused2;
                gather(xch, X_B, tag_b, -1, 0u, rzn, unused2, !kFull);
                if (tid == 0) {
                    const float rzf = (float)rzn;
                    const float rzo = s_rz;
                    s_beta = rzf / (rzo == 0.f ? 1.f : rzo);
                    s_rz = rzf;
                    if (!kFull) fence_acq_rel();
                    put_scalar(xch + kBetaWord, s_beta, tag_b);
                }
            } else if (tid == 0) {
                s_beta = get_scalar(xch + kBetaWord, tag_b);
                if (!kFull) fence_acq_rel();
            }
        } else {
            if (tid < 64 && wl > 0) {
                const int c0 = max(0, wlo), c1 = min(n, whi);
                const long long t0 = clock64();
                for (int j = c0 / R + tid - 32; j <= (c1 - 1) / R; j += 32) {
                    const unsigned long long* w =
                        xch + 2 * ((size_t)X_B * kMaxGrid + j);
                    while ((unsigned int)(ld_relaxed(w) >> 32) != tag_b ||
                           (unsigned int)(ld_relaxed(w + 1) >> 32) != tag_b)
                        if (clock64() - t0 > kSpinCycles) __trap();
                }
                fence_acq_rel();
            }
            asm volatile("bar.sync 1, %0;" ::"r"(T1) : "memory");
#pragma unroll
            for (int u = 0; u < kUnroll; ++u)
                zc[u] = load_z(tid - 32 + u * T1, k + 1);
        }
        __syncthreads();
        beta = s_beta;
        STAMP(5);
        if (tid >= 32) {
#pragma unroll
            for (int u = 0; u < kUnroll; ++u) {
                const int j = tid - 32 + u * T1;
                if (j < wl) pw[j] = combine(zc[u], j, k + 1, beta);
            }
        }
        build_window(k + 1, beta, kUnroll * T1);  // what did not fit
    }

    // ||r|| from the r.r partials of the last exchange
    if (blk == 0 && tid < 32) {
        const unsigned int tag_r =
            pl.tag0 + 2u * (unsigned int)pl.iters;  // t0 when iters == 0
        double rrs, unused3;
        gather(xch, X_R, tag_r, -1, 0u, rrs, unused3, false);
        if (tid == 0) *bf.res = sqrtf((float)rrs);
    }
    if (pl.stage_vec)
        for (int li = tid; li < nr; li += T) bf.x[s + li] = xv[li];
}

size_t smem_bytes(int chunk, int win, int stage_vec, int n_slots) {
    return sizeof(float) * ((size_t)(stage_vec ? 4 : 0) * chunk +
                            (size_t)n_slots * chunk + (size_t)win);
}

}  // namespace

extern "C" {

// 64-bit words of the exchange buffer the caller keeps per stream: zeroed
// once, then handed to every call with tags above the previous call's.
int dia_cg_f32_exchange_words(void) { return kBetaWord + 1; }

// What the host plan needs, for the current device: info[0] SMs,
// info[1] dynamic shared memory a block may use (the opt-in limit less the
// kernel's static shared memory), info[2] cooperative launch supported,
// info[3] the kernel's max threads per block, info[4] its registers per
// thread, info[5] its static shared memory, info[6] its local memory per
// thread (spills); the kernel with bounds checks, which has the larger
// footprint of the two.  Cached per device after the first query.  Returns 0
// or a CUDA error code.
int dia_cg_f32_device_info(int* info) {
    constexpr int kMaxDevices = 64;
    static int cache[kMaxDevices][7];
    static bool cached[kMaxDevices];
    int dev = 0, sms = 0, optin = 0, coop = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess && dev < kMaxDevices && cached[dev]) {
        for (int i = 0; i < 7; ++i) info[i] = cache[dev][i];
        return 0;
    }
    if (e == cudaSuccess)
        e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
        e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                   dev);
    if (e == cudaSuccess)
        e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
    cudaFuncAttributes fa, ff;
    if (e == cudaSuccess) e = cudaFuncGetAttributes(&fa, dia_cg_kernel<false>);
    if (e == cudaSuccess) e = cudaFuncGetAttributes(&ff, dia_cg_kernel<true>);
    if (e != cudaSuccess) return (int)e;
    const size_t stat = fa.sharedSizeBytes > ff.sharedSizeBytes
                            ? fa.sharedSizeBytes : ff.sharedSizeBytes;
    info[0] = sms;
    info[1] = optin - (int)stat;
    info[2] = coop;
    info[3] = fa.maxThreadsPerBlock < ff.maxThreadsPerBlock
                  ? fa.maxThreadsPerBlock : ff.maxThreadsPerBlock;
    info[4] = fa.numRegs;
    info[5] = (int)stat;
    info[6] = (int)fa.localSizeBytes;
    if (dev < kMaxDevices) {  // the same values whoever writes them
        for (int i = 0; i < 7; ++i) cache[dev][i] = info[i];
        cached[dev] = true;
    }
    return 0;
}

#ifdef DIA_CG_PHASE_STAMPS
int dia_cg_f32_set_stamps(void* stamps) {
    return (int)cudaMemcpyToSymbol(g_stamps, &stamps, sizeof(stamps));
}
#endif

const char* dia_cg_f32_error_string(int code) {
    switch (code) {
        case E_PLAN: return "invalid launch plan";
        case E_NO_COOP: return "the device does not support cooperative launch";
        case E_NOT_RESIDENT:
            return "the plan's blocks cannot all be resident at once";
        case E_SMEM: return "the plan needs more shared memory than a block has";
        default: return cudaGetErrorString(static_cast<cudaError_t>(code));
    }
}

// Fixed-budget Jacobi-PCG, x0 = 0, as one cooperative kernel.  Device memory:
//   vals (n_terms, n) f32 row-major diagonal table; b, dinv (n,) f32 inputs;
//   x (n,) f32 output; work (5, n) f32 scratch (r, z, Ap, p by parity);
//   xch (dia_cg_f32_exchange_words(),) u64 exchange buffer, zeroed before its
//   first use; res (1,) f32 output, ||r||.
// rows/offs/slot are HOST arrays of n_terms ints: each term's table row (the
// main or the positive-offset diagonal of |o|), its offset in table order,
// and its shared-memory slot or -1.  grid, threads, chunk, halo, win,
// stage_vec and n_slots are the launch plan (solvers/dia_cg.py::_plan).
// tag0 >= 1: the call uses tags tag0 .. tag0 + 2 iters, all above those of
// the previous call on the same xch (the caller re-zeroes xch before the
// tags would wrap).
// Returns 0, a negative plan error (dia_cg_f32_error_string), or the CUDA
// error code of the launch.
int dia_cg_f32(const float* vals, int n, int n_terms, const int* rows,
               const int* offs, const int* slot, int grid, int threads,
               int chunk, int halo, int win, int stage_vec, int n_slots,
               const float* b, const float* dinv, int iters, float* x,
               float* work, unsigned long long* xch, unsigned int tag0,
               float* res, void* stream) {
    if (n <= 0 || iters < 0 || n_terms < 1 || n_terms > kMaxTerms ||
        threads < 64 || threads > kThreads || threads % 32 != 0 || grid < 1 ||
        grid > kMaxGrid || chunk < 1 ||
        (long long)(grid - 1) * chunk >= n || (long long)grid * chunk < n ||
        halo < 0 || win < 0 ||
        (win > 0 && (long long)win != (long long)chunk + 2LL * halo) ||
        n_slots < 0 || n_slots > n_terms || tag0 == 0u ||
        (unsigned long long)tag0 + 2ull * (unsigned long long)iters > 0xffffffffull)
        return E_PLAN;
    Plan pl;
    pl.n = n;
    pl.iters = iters;
    pl.n_terms = n_terms;
    pl.chunk = chunk;
    pl.halo = halo;
    pl.win = win;
    pl.stage_vec = stage_vec ? 1 : 0;
    pl.n_slots = n_slots;
    pl.tag0 = tag0;
    bool full = win > 0 && n_slots == n_terms;
    for (int q = 0; q < kMaxTerms; ++q) {
        pl.rows[q] = q < n_terms ? rows[q] : 0;
        pl.offs[q] = q < n_terms ? offs[q] : 0;
        pl.slot[q] = q < n_terms ? slot[q] : -1;
        if (q >= n_terms) continue;
        if (pl.rows[q] < 0 || pl.rows[q] >= n_terms || pl.slot[q] < -1 ||
            pl.slot[q] >= n_slots)
            return E_PLAN;
        const int m = pl.offs[q] < 0 ? -pl.offs[q] : pl.offs[q];
        if (pl.slot[q] != q || m > halo) full = false;
    }
    Bufs bf;
    bf.vals = vals;
    bf.b = b;
    bf.dinv = dinv;
    bf.x = x;
    bf.r = work;
    bf.z = work + (size_t)n;
    bf.Ap = work + 2 * (size_t)n;
    bf.P = work + 3 * (size_t)n;
    bf.xch = xch;
    bf.res = res;

    int info[7];
    int e = dia_cg_f32_device_info(info);
    if (e != 0) return e;
    if (!info[2]) return E_NO_COOP;
    if (threads > info[3]) return E_PLAN;
    const size_t smem = smem_bytes(chunk, win, pl.stage_vec, n_slots);
    if (smem > (size_t)info[1]) return E_SMEM;
    const void* fn = full ? (const void*)dia_cg_kernel<true>
                          : (const void*)dia_cg_kernel<false>;
    cudaError_t ce = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (ce != cudaSuccess) return (int)ce;
    int per_sm = 0;
    ce = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, threads,
                                                       smem);
    if (ce != cudaSuccess) return (int)ce;
    if ((long long)per_sm * info[0] < grid) return E_NOT_RESIDENT;
    void* args[] = {&pl, &bf};
    ce = cudaLaunchCooperativeKernel(fn, dim3(grid), dim3(threads), args, smem,
                                     static_cast<cudaStream_t>(stream));
    if (ce != cudaSuccess) return (int)ce;
    return (int)cudaGetLastError();
}

}  // extern "C"
