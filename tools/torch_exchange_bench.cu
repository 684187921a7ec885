// What one grid-wide exchange of partial sums costs on the card, alone.
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 \
//        -o /tmp/exchange_bench tools/torch_exchange_bench.cu && /tmp/exchange_bench
//
// A cooperative kernel of G blocks does nothing but 2,000 exchanges in a row,
// the protocol of ngsxfem_tpu_torch/csrc/dia_cg.cu: every block publishes a
// partial as tagged 64-bit words, regions alternate by round so that no slot
// is rewritten while it may still be read, and the first warp of a block
// polls with all of a pass's loads in flight.  Variants:
//   all-gather     every block's first warp gathers every partial;
//   block0+bcast   block 0 gathers and publishes one tagged word that the
//                  other blocks wait for (the kernel's design);
//   words          2 words per partial (an f64 split beside its tag) or 1;
//   fences         a release fence before each publication and an acquire
//                  fence after each wait, or none.
// Prints ns per exchange (block 0's clock over all rounds) for G = 115
// (the nx=48 plan), 32 and 8 blocks of 1024 threads.
#include <cuda_runtime.h>

#include <cstdio>

typedef unsigned long long u64;

__device__ __forceinline__ void fence_acq_rel() {
    asm volatile("fence.acq_rel.gpu;" ::: "memory");
}
__device__ __forceinline__ void st_relaxed(u64* p, u64 v) {
    asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}
__device__ __forceinline__ u64 ld_relaxed(const u64* p) {
    u64 v;
    asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
    return v;
}
__device__ __forceinline__ u64 gtime() {
    u64 t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    return t;
}

enum { ALL_GATHER = 0, BLOCK0_BCAST = 1 };
constexpr int kRegion = 1024;  // slots per region; regions alternate by round

// slots: (2 regions, kRegion, 2 words); bcast: 2 words; tag0: tags of this
// run start above every earlier run's
__global__ void exchange(u64* slots, u64* bcast, int rounds, int mode,
                         int words, int fences, unsigned tag0, u64* out) {
    const int G = gridDim.x, lane = threadIdx.x, blk = blockIdx.x;
    __shared__ double s_sum;
    const u64 t0 = gtime();
    for (int r = 0; r < rounds; ++r) {
        const unsigned tag = tag0 + (unsigned)r;
        u64* region = slots + 2 * (size_t)kRegion * (r & 1);
        __syncthreads();
        if (threadIdx.x == 0) {
            if (fences) fence_acq_rel();
            st_relaxed(region + 2 * blk, ((u64)tag << 32) | 5u);
            if (words == 2) st_relaxed(region + 2 * blk + 1, ((u64)tag << 32) | 7u);
        }
        const bool gathers = mode == ALL_GATHER || blk == 0;
        if (threadIdx.x < 32 && gathers) {
            double u = 0.0;
            for (int j0 = 0; j0 < G; j0 += 128) {
                double au[4];
                for (;;) {
                    bool ok = true;
#pragma unroll
                    for (int m = 0; m < 4; ++m) {
                        const int j = j0 + lane + 32 * m;
                        au[m] = 0.0;
                        if (j < G) {
                            const u64 lo = ld_relaxed(region + 2 * j);
                            ok = ok && (unsigned)(lo >> 32) == tag;
                            au[m] = (double)(unsigned)lo;
                            if (words == 2) {
                                const u64 hi = ld_relaxed(region + 2 * j + 1);
                                ok = ok && (unsigned)(hi >> 32) == tag;
                                au[m] += (double)(unsigned)hi;
                            }
                        }
                    }
                    if (__all_sync(0xffffffffu, ok)) break;
                    if (gtime() - t0 > 2000000000ull) __trap();  // 2 s
                }
                for (int m = 0; m < 4; ++m) u += au[m];
            }
            if (fences) fence_acq_rel();
            for (int o = 16; o > 0; o >>= 1) u += __shfl_xor_sync(0xffffffffu, u, o);
            if (lane == 0) {
                s_sum = u;
                if (mode == BLOCK0_BCAST) {
                    if (fences) fence_acq_rel();
                    st_relaxed(bcast + (r & 1), ((u64)tag << 32) | (unsigned)u);
                }
            }
        } else if (threadIdx.x == 0 && mode == BLOCK0_BCAST) {
            u64 v;
            while ((unsigned)((v = ld_relaxed(bcast + (r & 1))) >> 32) != tag)
                if (gtime() - t0 > 2000000000ull) __trap();
            if (fences) fence_acq_rel();
            s_sum = (double)(unsigned)v;
        }
        __syncthreads();
    }
    if (blk == 0 && threadIdx.x == 0) {
        out[0] = gtime() - t0;
        out[1] = (u64)s_sum;  // keeps the sums live
    }
}

int main() {
    u64 *slots, *bcast, *out;
    cudaMalloc(&slots, 2 * kRegion * 2 * sizeof(u64));
    cudaMemset(slots, 0, 2 * kRegion * 2 * sizeof(u64));
    cudaMalloc(&bcast, 2 * sizeof(u64));
    cudaMemset(bcast, 0, 2 * sizeof(u64));
    cudaMalloc(&out, 2 * sizeof(u64));
    char name[64];
    cudaDeviceProp prop;
    cudaGetDeviceProperties(&prop, 0);
    printf("%s, %d SMs\n", prop.name, prop.multiProcessorCount);
    unsigned tag0 = 1;
    int rounds = 2000, threads = 1024;
    const int grids[] = {115, 32, 8};
    for (int G : grids)
        for (int mode = 0; mode < 2; ++mode)
            for (int words = 2; words >= 1; --words)
                for (int fences = 1; fences >= 0; --fences) {
                    void* args[] = {&slots, &bcast, &rounds, &mode, &words,
                                    &fences, &tag0, &out};
                    cudaError_t e = cudaLaunchCooperativeKernel(
                        (void*)exchange, dim3(G), dim3(threads), args, 0, 0);
                    if (e == cudaSuccess) e = cudaDeviceSynchronize();
                    if (e != cudaSuccess) {
                        printf("error: %s\n", cudaGetErrorString(e));
                        return 1;
                    }
                    tag0 += rounds;
                    u64 ns = 0;
                    cudaMemcpy(&ns, out, sizeof(ns), cudaMemcpyDeviceToHost);
                    snprintf(name, sizeof(name), "%s, %d word%s, %s",
                             mode == ALL_GATHER ? "all-gather" : "block0+bcast",
                             words, words == 2 ? "s" : "",
                             fences ? "fences" : "no fences");
                    printf("grid %3d  %-38s %8.1f ns per exchange\n", G, name,
                           (double)ns / rounds);
                    fflush(stdout);
                }
    return 0;
}
