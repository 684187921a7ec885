// The lattice DIA table of the flagship model, hand-written for Hopper
// (sm_90a): V (n_off, n) of UnfittedPoisson.assemble_vals_lattice on the
// structured tet mesh (3D, order 1), one launch per assembly.
//
// Replaces no TPU kernel: in the JAX package assemble_vals_lattice
// (ngsxfem_tpu/models/poisson.py) is jnp code over lattice windows that XLA
// fuses.  The port ran it eagerly (models/poisson.py): the closed forms
// cut_poisson_flat_soa over the 6 tet types and ghost_penalty_flat_soa over
// the 12 facet types as masked tensor arithmetic on 110,592-cell windows,
// then a windowed add per table entry group: some 27,300 launches at nx=48,
// for a table of 12.7 MB that the card writes in ~4 us.
//
// What bounds it, and what the design does about it:
//   - The call was bound by its launches.  So it is one launch: each thread
//     owns a row of the table (a lattice vertex) and writes its n_off
//     entries once.  It gathers: it recomputes in registers the element
//     matrices of the tets around its vertex and the ghost-penalty patch
//     matrices of the facet patches that touch it, and sums their entries
//     into its row.  No atomics on the table, no element matrices in device
//     memory, no host sync, no copy to the card per call.  Each element is
//     computed once per corner (24 per row), each patch once per vertex.
//   - The plan is data, made once per model and offset set by the wrapper
//     (models/lattice_asm.py) from the eager path's own group lists and
//     uploaded once: the element units (the cubes around a vertex, the tets
//     of each that hold it, and the diagonal of each entry of its row), the
//     corner displacements of the tet types, the decomposition of a cut tet
//     for each of its 16 sign patterns (ops/cuttables._decompose), the P1
//     basis, and per facet type the units (the patch positions of the
//     vertex) with their (i, j, diagonal) terms.  A block copies it to
//     shared memory, where a warp's reads of one entry are a broadcast.
//     Nothing is compiled per facet type or per pattern.
//   - The device work is small (a few hundred flops per uncut element, a
//     few thousand per cut element or active patch) and the bytes are the
//     table once plus the vertices and the level set, read through L1.
//     A cut element branches on its sign pattern (the eager path masks all
//     16), an element with no negative corner and a patch outside the
//     ghost-penalty band are skipped: their terms are exact zeros.
//
// The sums are the eager path's on the card, bit for bit, signed zeros
// aside (an entry may be +0 where it is -0 there):
//   - per entry the element groups in sorted (diagonal, displacement)
//     order, each group a left fold over its tets in order, then the facet
//     types in the plan's order, their groups sorted, then the identity row;
//   - each operation rounded separately (__fmul_rn / __fadd_rn / ... and
//     the double versions: never a contracted FMA), IEEE division and
//     square root, powf / pow, a division by a constant as ATen's CUDA
//     kernels do it (the product with its reciprocal), 1 / x as a division,
//     the level set snapped to +eps below eps in magnitude (eps_guard).
// The count of cut elements is an exact integer sum (each element counted
// by the row of its corner 0; each block adds its count with an integer
// atomic into ncut, which the caller zeroes), left on the card.  The kernel launches on the caller's stream, on the current device,
// which the wrapper sets; it never synchronises, and the C entries return
// the CUDA error of the launch, 0 on success.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxOff = 32;     // offsets of the table (the wrapper checks)

// header of the plan (models/lattice_asm.py, plan_tables): the ints at
// these places give the counts and the starts of the sections
enum Header {
    kNOff = 0, kK0, kNTypes, kElemUnits, kElemStart, kCornerStart,
    kVperm, kBasisStart, kDecompStart, kGpTypes, kGpStart, kHeaderLen
};
constexpr int kPatternInts = 2 + 6 * 4 + 2 * 3;   // per sign pattern

__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float quo(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ float root(float a) { return __fsqrt_rn(a); }
__device__ __forceinline__ float power(float a, float b) { return powf(a, b); }
__device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ double quo(double a, double b) { return __ddiv_rn(a, b); }
__device__ __forceinline__ double root(double a) { return __dsqrt_rn(a); }
__device__ __forceinline__ double power(double a, double b) { return pow(a, b); }

// clamp_min(x, lo) as ATen's: a NaN stays
template <typename T>
__device__ __forceinline__ T clamp_lo(T x, T lo) { return x < lo ? lo : x; }

// the scalars of the call, in T: each as ATen's CUDA kernels convert it
template <typename T>
struct Consts {
    T eps;        // config.lset_eps
    T lam;        // lam_nitsche
    T gamma;      // gamma_gp
    T tiny;       // 1e-30 of the clamps and of tpar's guard
    T sixth;      // 1.0 / 3! of the uncut element's reference volume
    T inv6, inv3; // x / 6.0 and x / 3.0 as x * (1 / 6), x * (1 / 3)
    T third;      // 1.0 / d, the exponent of h
    T two_thirds; // 2.0 / d, the exponent of h^2
    T c20;        // 1 / ((d + 1) (d + 2)) of the patch integral
};

template <typename T>
struct Lattice {
    const T* __restrict__ X;   // (n, 3) vertex coordinates
    const T* __restrict__ L;   // (n,) level set
    int nv1;                   // vertices per axis
    int nx;                    // cells per axis
};

// the eps-guarded value of the level set (ops/straightcut.eps_guard)
template <typename T>
__device__ __forceinline__ T guarded(T v, T eps) {
    return fabs(v) < eps ? eps : v;
}

template <typename T>
__device__ __forceinline__ long long vid(const Lattice<T>& g, int z, int y, int x) {
    return ((long long)z * g.nv1 + y) * g.nv1 + x;
}

// corner q of tet type t in cube (cz, cy, cx): coordinates and level set
template <typename T>
__device__ __forceinline__ void corners(const Lattice<T>& g, const int* cd,
                                        int t, int cz, int cy, int cx,
                                        T X[4][3], T Lr[4]) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
        const int* o = cd + (t * 4 + q) * 3;
        const long long v = vid(g, cz + o[0], cy + o[1], cx + o[2]);
        X[q][0] = __ldg(g.X + 3 * v);
        X[q][1] = __ldg(g.X + 3 * v + 1);
        X[q][2] = __ldg(g.X + 3 * v + 2);
        Lr[q] = __ldg(g.L + v);
    }
}

// models/poisson._soa_jacobian (3D) of corners X: det and J^{-1}
template <typename T>
__device__ __forceinline__ T jacobian(const T X[4][3], T Ji[3][3]) {
    T J[3][3];
#pragma unroll
    for (int a = 0; a < 3; ++a)
#pragma unroll
        for (int b = 0; b < 3; ++b) J[a][b] = sub(X[b + 1][a], X[0][a]);
    const T c00 = sub(mul(J[1][1], J[2][2]), mul(J[1][2], J[2][1]));
    const T c01 = sub(mul(J[0][2], J[2][1]), mul(J[0][1], J[2][2]));
    const T c02 = sub(mul(J[0][1], J[1][2]), mul(J[0][2], J[1][1]));
    const T c10 = sub(mul(J[1][2], J[2][0]), mul(J[1][0], J[2][2]));
    const T c11 = sub(mul(J[0][0], J[2][2]), mul(J[0][2], J[2][0]));
    const T c12 = sub(mul(J[0][2], J[1][0]), mul(J[0][0], J[1][2]));
    const T c20 = sub(mul(J[1][0], J[2][1]), mul(J[1][1], J[2][0]));
    const T c21 = sub(mul(J[0][1], J[2][0]), mul(J[0][0], J[2][1]));
    const T c22 = sub(mul(J[0][0], J[1][1]), mul(J[0][1], J[1][0]));
    const T det = add(add(mul(J[0][0], c00), mul(J[0][1], c10)), mul(J[0][2], c20));
    // 1.0 / det: the reciprocal, then the product with 1.0 (exact)
    const T inv = quo(T(1), det);
    Ji[0][0] = mul(c00, inv); Ji[0][1] = mul(c01, inv); Ji[0][2] = mul(c02, inv);
    Ji[1][0] = mul(c10, inv); Ji[1][1] = mul(c11, inv); Ji[1][2] = mul(c12, inv);
    Ji[2][0] = mul(c20, inv); Ji[2][1] = mul(c21, inv); Ji[2][2] = mul(c22, inv);
    return det;
}

// the P1 basis (models/poisson._p1_affine_basis), Lagrange order: values
// b0[i] + G[i] . p and reference vertices R[i]
struct Basis {
    const int* b0;   // [4]
    const int* G;    // [4][3]
    const int* R;    // [4][3]
};

// point of a cut spec (a, b): vertex a, or the point of edge (a, b) where
// the level set changes sign (cut_poisson_flat_soa's pt and tpar)
template <typename T>
__device__ __forceinline__ void spec_point(int spec, const T lv[4], const Basis& B,
                                           const Consts<T>& c, T p[3]) {
    const int a = spec >> 2, b = spec & 3;
    if (a == b) {
#pragma unroll
        for (int g = 0; g < 3; ++g) p[g] = T(B.R[a * 3 + g]);
        return;
    }
    T den = sub(lv[a], lv[b]);
    den = fabs(den) < c.tiny ? T(1) : den;
    const T t = quo(lv[a], den);
#pragma unroll
    for (int g = 0; g < 3; ++g)
        p[g] = add(T(B.R[a * 3 + g]), mul(t, T(B.R[b * 3 + g] - B.R[a * 3 + g])));
}

// row i (Lagrange order) of the element matrix of cut_poisson_flat_soa for
// the tet with corners X (corner order) and eps-guarded level set lg
// (corner order).  False where the element has no negative corner: its
// matrix is zero.
template <typename T>
__device__ bool element_row(const int* plan, const Consts<T>& c, const T X[4][3],
                            const T lg[4], int i, T out[4]) {
    const int* vperm = plan + plan[kVperm];
    const int* bas = plan + plan[kBasisStart];
    const Basis B{bas, bas + 4, bas + 16};
    T lv[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) lv[vperm[q]] = lg[q];
    int pat = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) pat |= (lv[j] > T(0) ? 1 : 0) << j;
    if (pat == 15) return false;

    T Ji[3][3];
    const T det = jacobian(X, Ji);
    const T absdet = fabs(det);
    T Gp[4][3];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int g = 0; g < 3; ++g) {
            T s = mul(T(B.G[j * 3]), Ji[0][g]);
            s = add(s, mul(T(B.G[j * 3 + 1]), Ji[1][g]));
            Gp[j][g] = add(s, mul(T(B.G[j * 3 + 2]), Ji[2][g]));
        }
    // K[lo][hi] of the row's four entries (the eager path's j >= i half)
    T K[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
        const int lo = i < j ? i : j, hi = i < j ? j : i;
        K[j] = add(add(mul(Gp[lo][0], Gp[hi][0]), mul(Gp[lo][1], Gp[hi][1])),
                   mul(Gp[lo][2], Gp[hi][2]));
    }
    if (pat == 0) {   // uncut NEG element: Wvol = 1 / 3!
        const T Wp = mul(c.sixth, absdet);
#pragma unroll
        for (int j = 0; j < 4; ++j) out[j] = mul(Wp, K[j]);
        return true;
    }

    // the cut element: level-set gradients, normal, Nitsche scalars
    T gref[3], gphys[3], nphys[3], dn[4];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
        T s = mul(T(B.G[a]), lv[0]);
#pragma unroll
        for (int j = 1; j < 4; ++j) s = add(s, mul(T(B.G[j * 3 + a]), lv[j]));
        gref[a] = s;
    }
#pragma unroll
    for (int g = 0; g < 3; ++g)
        gphys[g] = add(add(mul(Ji[0][g], gref[0]), mul(Ji[1][g], gref[1])),
                       mul(Ji[2][g], gref[2]));
    const T ngref = root(add(add(mul(gref[0], gref[0]), mul(gref[1], gref[1])),
                             mul(gref[2], gref[2])));
    const T ngphys = root(add(add(mul(gphys[0], gphys[0]), mul(gphys[1], gphys[1])),
                              mul(gphys[2], gphys[2])));
    const T nsafe = clamp_lo(ngphys, c.tiny);
#pragma unroll
    for (int g = 0; g < 3; ++g) nphys[g] = quo(gphys[g], nsafe);
#pragma unroll
    for (int j = 0; j < 4; ++j)
        dn[j] = add(add(mul(Gp[j][0], nphys[0]), mul(Gp[j][1], nphys[1])),
                    mul(Gp[j][2], nphys[2]));
    const T ifscale = quo(mul(absdet, ngphys), clamp_lo(ngref, c.tiny));
    const T h = power(absdet, c.third);
    const T lam = mul(quo(T(1), clamp_lo(h, c.tiny)), c.lam);

    const int* pt = plan + plan[kDecompStart] + pat * kPatternInts;
    const int nsub = pt[0], nif = pt[1];
    const int* subs = pt + 2;
    const int* ifs = pt + 2 + 6 * 4;
    // NEG volume in reference coordinates: the NEG sub-tets in order
    T Wvol = T(0);
    for (int s = 0; s < nsub; ++s) {
        T ps[4][3];
#pragma unroll
        for (int q = 0; q < 4; ++q) spec_point(subs[s * 4 + q], lv, B, c, ps[q]);
        T e[3][3];
#pragma unroll
        for (int k = 0; k < 3; ++k)
#pragma unroll
            for (int g = 0; g < 3; ++g) e[k][g] = sub(ps[k + 1][g], ps[0][g]);
        T vol = add(sub(mul(e[0][0], sub(mul(e[1][1], e[2][2]), mul(e[1][2], e[2][1]))),
                        mul(e[0][1], sub(mul(e[1][0], e[2][2]), mul(e[1][2], e[2][0])))),
                    mul(e[0][2], sub(mul(e[1][0], e[2][1]), mul(e[1][1], e[2][0]))));
        Wvol = add(Wvol, mul(fabs(vol), c.inv6));
    }
    const T Wp = mul(Wvol, absdet);
#pragma unroll
    for (int j = 0; j < 4; ++j) out[j] = mul(Wp, K[j]);

    // Nitsche terms at the edge midpoints of each interface triangle
    for (int f = 0; f < nif; ++f) {
        T ps[3][3];
#pragma unroll
        for (int q = 0; q < 3; ++q) spec_point(ifs[f * 3 + q], lv, B, c, ps[q]);
        T u[3], v[3];
#pragma unroll
        for (int g = 0; g < 3; ++g) {
            u[g] = sub(ps[1][g], ps[0][g]);
            v[g] = sub(ps[2][g], ps[0][g]);
        }
        const T cx = sub(mul(u[1], v[2]), mul(u[2], v[1]));
        const T cy = sub(mul(u[2], v[0]), mul(u[0], v[2]));
        const T cz = sub(mul(u[0], v[1]), mul(u[1], v[0]));
        const T area = mul(T(0.5), root(add(add(mul(cx, cx), mul(cy, cy)), mul(cz, cz))));
        const T w = mul(area, c.inv3);
        const T wp = mul(w, ifscale);
        const T wl = mul(wp, lam);
#pragma unroll
        for (int m = 0; m < 3; ++m) {
            const int a = m == 2 ? 0 : m, b = m == 0 ? 1 : 2;   // (0,1) (1,2) (0,2)
            T q[3], Bv[4];
#pragma unroll
            for (int g = 0; g < 3; ++g) q[g] = mul(T(0.5), add(ps[a][g], ps[b][g]));
#pragma unroll
            for (int j = 0; j < 4; ++j)
                Bv[j] = add(add(add(mul(T(B.G[j * 3]), q[0]), mul(T(B.G[j * 3 + 1]), q[1])),
                                mul(T(B.G[j * 3 + 2]), q[2])),
                            T(B.b0[j]));
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const int lo = i < j ? i : j, hi = i < j ? j : i;
                out[j] = add(sub(out[j], mul(wp, add(mul(dn[lo], Bv[hi]), mul(dn[hi], Bv[lo])))),
                             mul(mul(wl, Bv[lo]), Bv[hi]));
            }
        }
    }
    return true;
}

// all P1 basis values of the element (Ji, x0) at the physical point p
// (ghost_penalty_flat_soa's basis_at)
template <typename T>
__device__ __forceinline__ void basis_at(const Basis& B, const T Ji[3][3], const T x0[3],
                                         const T p[3], T out[4]) {
    T d[3], xi[3];
#pragma unroll
    for (int g = 0; g < 3; ++g) d[g] = sub(p[g], x0[g]);
#pragma unroll
    for (int a = 0; a < 3; ++a)
        xi[a] = add(add(mul(Ji[a][0], d[0]), mul(Ji[a][1], d[1])), mul(Ji[a][2], d[2]));
#pragma unroll
    for (int j = 0; j < 4; ++j)
        out[j] = add(add(add(mul(T(B.G[j * 3]), xi[0]), mul(T(B.G[j * 3 + 1]), xi[1])),
                         mul(T(B.G[j * 3 + 2]), xi[2])),
                     T(B.b0[j]));
}

// the jump table F (8 x 8) and weights of ghost_penalty_flat_soa for the
// patch of tets X1, X2 (corner order); entry (i, j) of the patch matrix is
// then patch_entry(F, w1, w2, i, j)
template <typename T>
__device__ void patch_table(const int* plan, const Consts<T>& c, const T X1[4][3],
                            const T X2[4][3], T F[8][8], T& w1, T& w2) {
    const int* vperm = plan + plan[kVperm];
    const int* bas = plan + plan[kBasisStart];
    const Basis B{bas, bas + 4, bas + 16};
    T Ji1[3][3], Ji2[3][3];
    const T det1 = jacobian(X1, Ji1);
    const T det2 = jacobian(X2, Ji2);
    const T V1 = mul(fabs(det1), c.inv6);
    const T V2 = mul(fabs(det2), c.inv6);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
        T b21[4], b12[4];
        basis_at(B, Ji2, X2[0], X1[k], b21);
        basis_at(B, Ji1, X1[0], X2[k], b12);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const bool own = i == vperm[k];
            F[i][k] = own ? T(1) : T(0);
            F[i][4 + k] = b12[i];
            F[4 + i][k] = -b21[i];
            F[4 + i][4 + k] = own ? T(-1) : T(0);
        }
    }
    const T h2 = power(fabs(det1), c.two_thirds);
    const T scale = mul(quo(T(1), clamp_lo(h2, c.tiny)), c.gamma);
    w1 = mul(mul(scale, V1), c.c20);
    w2 = mul(mul(scale, V2), c.c20);
}

template <typename T>
__device__ __forceinline__ T patch_entry(const T F[8][8], T w1, T w2, int i, int j) {
    T s1 = mul(F[i][0], F[j][0]), s2 = mul(F[i][4], F[j][4]);
    T si1 = F[i][0], sj1 = F[j][0], si2 = F[i][4], sj2 = F[j][4];
#pragma unroll
    for (int k = 1; k < 4; ++k) {
        s1 = add(s1, mul(F[i][k], F[j][k]));
        s2 = add(s2, mul(F[i][4 + k], F[j][4 + k]));
        si1 = add(si1, F[i][k]);
        sj1 = add(sj1, F[j][k]);
        si2 = add(si2, F[i][4 + k]);
        sj2 = add(sj2, F[j][4 + k]);
    }
    return add(mul(w1, add(s1, mul(si1, sj1))), mul(w2, add(s2, mul(si2, sj2))));
}

// the eps-guarded HASNEG / HASPOS of tet t in cube (cz, cy, cx)
template <typename T>
__device__ __forceinline__ void signs(const Lattice<T>& g, const int* cd, int t,
                                      int cz, int cy, int cx, T eps,
                                      bool& neg, bool& pos) {
    neg = pos = false;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
        const int* o = cd + (t * 4 + q) * 3;
        const T v = guarded(__ldg(g.L + vid(g, cz + o[0], cy + o[1], cx + o[2])), eps);
        neg |= v < T(0);
        pos |= v > T(0);
    }
}

__device__ __forceinline__ bool in_cells(int z, int y, int x, int nz, int ny, int nxx) {
    return z >= 0 && z < nz && y >= 0 && y < ny && x >= 0 && x < nxx;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
lattice_asm_kernel(Lattice<T> g, T* __restrict__ V,
                   unsigned long long* __restrict__ ncut,
                   const int* __restrict__ plan_g, int plan_len, Consts<T> c) {
    extern __shared__ int plan[];
    __shared__ int block_cut;
    for (int q = threadIdx.x; q < plan_len; q += kThreads) plan[q] = plan_g[q];
    if (threadIdx.x == 0) block_cut = 0;
    __syncthreads();

    const int nv1 = g.nv1, nx = g.nx;
    const long long n = (long long)nv1 * nv1 * nv1;
    const long long r = (long long)blockIdx.x * kThreads + threadIdx.x;
    int my_cut = 0;
    if (r < n) {
        const int vz = (int)(r / ((long long)nv1 * nv1));
        const int vy = (int)((r / nv1) % nv1);
        const int vx = (int)(r % nv1);
        const int n_off = plan[kNOff];
        const int* cd = plan + plan[kCornerStart];
        T acc[kMaxOff], s[kMaxOff];
#pragma unroll
        for (int k = 0; k < kMaxOff; ++k) acc[k] = T(0);
        bool act = false;

        // 1. the element groups: per cube around the vertex (displacement
        // ascending), each tet holding the vertex (t ascending), row i of
        // its matrix into the unit's sums; then the sums into the row
        const int* u = plan + plan[kElemStart];
        for (int e = 0; e < plan[kElemUnits]; ++e) {
            const int cz = vz - u[0], cy = vy - u[1], cx = vx - u[2];
            const int nvis = u[3], nks = u[4];
            const int* ks = u + 5;
            const int* vis = ks + nks;
            u = vis + 6 * nvis;
            if (!in_cells(cz, cy, cx, nx, nx, nx)) continue;
            for (int q = 0; q < nks; ++q) s[ks[q]] = T(0);
            for (int w = 0; w < nvis; ++w) {
                const int* vv = vis + 6 * w;
                const int t = vv[0], i = vv[1];
                T X[4][3], Lr[4], lg[4];
                corners(g, cd, t, cz, cy, cx, X, Lr);
                bool neg = false, pos = false;
#pragma unroll
                for (int q = 0; q < 4; ++q) {
                    act |= Lr[q] < T(0);          // identity rows: the raw sign
                    lg[q] = guarded(Lr[q], c.eps);
                    neg |= lg[q] < T(0);
                    pos |= lg[q] > T(0);
                }
                if (i == 0 && neg && pos) ++my_cut;
                T row[4];
                if (element_row(plan, c, X, lg, i, row)) {
#pragma unroll
                    for (int j = 0; j < 4; ++j) s[vv[2 + j]] = add(s[vv[2 + j]], row[j]);
                }
            }
            for (int q = 0; q < nks; ++q) acc[ks[q]] = add(acc[ks[q]], s[ks[q]]);
        }

        // 2. the ghost penalty: per facet type, per position of the vertex
        // in its patch (displacement ascending), the patch where it lies in
        // the band; its terms folded per diagonal into the row
        const int* p = plan + plan[kGpStart];
        for (int ty = 0; ty < plan[kGpTypes]; ++ty) {
            const int ta = p[0], tb = p[1], dz = p[2], dy = p[3], dx = p[4];
            const int nunits = p[5];
            p += 6;
            for (int un = 0; un < nunits; ++un) {
                const int wz = vz - p[0], wy = vy - p[1], wx = vx - p[2];
                const int nterm = p[3];
                const int* terms = p + 4;
                p = terms + nterm;
                if (!in_cells(wz, wy, wx, nx - dz, nx - dy, nx - dx)) continue;
                bool n1, p1, n2, p2;
                signs(g, cd, ta, wz, wy, wx, c.eps, n1, p1);
                signs(g, cd, tb, wz + dz, wy + dy, wx + dx, c.eps, n2, p2);
                if (!((n1 && p1 && n2) || (n2 && p2 && n1))) continue;
                T X1[4][3], X2[4][3], L1[4], L2[4], F[8][8], w1, w2;
                corners(g, cd, ta, wz, wy, wx, X1, L1);
                corners(g, cd, tb, wz + dz, wy + dy, wx + dx, X2, L2);
                patch_table(plan, c, X1, X2, F, w1, w2);
                T sum = T(0);
                for (int q = 0; q < nterm; ++q) {
                    const int tm = terms[q];
                    const int k = tm >> 8;
                    sum = add(sum, patch_entry(F, w1, w2, tm & 15, (tm >> 4) & 15));
                    if (q + 1 == nterm || (terms[q + 1] >> 8) != k) {
                        acc[k] = add(acc[k], sum);
                        sum = T(0);
                    }
                }
            }
        }

        // 3. the identity row of an inactive vertex
        if (!act) acc[plan[kK0]] = add(acc[plan[kK0]], T(1));
        for (int k = 0; k < n_off; ++k) V[(long long)k * n + r] = acc[k];
    }

    // the cut count: a block's sum, then the grid's, exact integers
    if (my_cut) atomicAdd(&block_cut, my_cut);
    __syncthreads();
    if (threadIdx.x == 0 && block_cut)
        atomicAdd(ncut, (unsigned long long)block_cut);
}

template <typename T>
int launch(const T* X, const T* L, T* V, long long* ncut, const int* plan,
           int plan_len, int nx, double eps, double lam, double gamma,
           void* stream) {
    const size_t shmem = (size_t)plan_len * sizeof(int);
    if (nx < 1 || plan_len < kHeaderLen || shmem > 48 * 1024)
        return static_cast<int>(cudaErrorInvalidValue);
    const long long nv1 = nx + 1;
    const long long n = nv1 * nv1 * nv1;
    const long long nb = (n + kThreads - 1) / kThreads;
    if (nb > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
    Consts<T> c;
    c.eps = T(eps);
    c.lam = T(lam);
    c.gamma = T(gamma);
    c.tiny = T(1e-30);
    c.sixth = T(1.0 / 6.0);
    c.inv6 = T(1) / T(6);
    c.inv3 = T(1) / T(3);
    c.third = T(1.0 / 3.0);
    c.two_thirds = T(2.0 / 3.0);
    c.c20 = T(1.0 / 20.0);
    Lattice<T> g{X, L, (int)nv1, nx};
    lattice_asm_kernel<T><<<(unsigned)nb, kThreads, shmem,
                            static_cast<cudaStream_t>(stream)>>>(
        g, V, reinterpret_cast<unsigned long long*>(ncut), plan, plan_len, c);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* lattice_asm_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// V (n_off, n) row-major and ncut (int64 scalar, zero on entry: the kernel
// adds the count to it) of the lattice assembly of the vertex coordinates
// X (n, 3) and the level set L (n,), n = (nx + 1)^3, all device memory on
// the current device, launched on `stream`.  `plan` (plan_len ints) is the
// wrapper's device buffer of the model and offset set; eps, lam and gamma
// the scalars of the call.
// Returns 0, or the CUDA error code of the launch.
int lattice_asm_f32(const float* X, const float* L, float* V, long long* ncut,
                    const int* plan, int plan_len, int nx, double eps,
                    double lam, double gamma, void* stream) {
    return launch<float>(X, L, V, ncut, plan, plan_len, nx, eps, lam, gamma,
                         stream);
}

int lattice_asm_f64(const double* X, const double* L, double* V, long long* ncut,
                    const int* plan, int plan_len, int nx, double eps,
                    double lam, double gamma, void* stream) {
    return launch<double>(X, L, V, ncut, plan, plan_len, nx, eps, lam, gamma,
                          stream);
}

}  // extern "C"
