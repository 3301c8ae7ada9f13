// RG-LRU linear recurrence for Hopper (sm_90a).
//
// Replaces the TPU Pallas kernel repro/kernels/rg_lru/kernel.py::rg_lru_fwd
// (kernel.py:48, pallas_call at :58): h_t = a_t * h_{t-1} + b_t per
// (batch, channel), h_{-1} = 0, fp32 arithmetic, output in a's dtype. It
// is held bit for bit to the plain version
// repro_torch/kernels/rg_lru/ref.py: the multiply and the add are the
// explicitly rounded __fmul_rn and __fadd_rn, never contracted into an
// FMA, as the plain version's two torch operations are not.
//
// What bounds it on the H100. The function reads a and b once and writes
// h once: at RecurrentGemma-9B's [1, 4096, 4096] fp32 that is 201 MB,
// 60 us at 3.35 TB/s, and only 2 FLOP per element, so bytes bound it.
//
// Two routes, chosen by the caller (kernel.py) and passed in `tma`:
//
// rg_lru_tma_kernel (the path's route). One sequential chain per (batch,
// channel), walked in t: a block owns 32 neighbouring channels of one
// batch row. t is not split into chunks scanned in parallel: that
// would change the rounding and lose bit-equality, and the chain, two
// rounded operations (about 8 cycles) a step, is about 18 us over 4096
// steps, under the 60 us bytes bound. What keeps the kernel from its bound
// is latency: HBM at 3.35 TB/s and about 1 us loaded latency needs 2-3 MB
// in flight, 15-25 KB per SM. So a producer warp streams a and b by TMA
// (a 3-d tensor map over (C, S, B), zeros outside it) into a ring of 6
// stages in shared memory, each a tile of 32 steps x 32 channels of both
// arrays, completing on one "full" mbarrier a stage; the consumer warp
// reads its lane's a and b from the tile (off the dependent chain), runs
// the chain, writes h as one coalesced row a step, and releases the stage
// on its "empty" mbarrier. The ring holds 48 KB a
// block: one block an SM at [1, 4096, 4096] keeps 40 KB in flight, and
// four fit an SM, so the 512 blocks of [4, 4096, 4096] run in one wave.
// TMA needs 16-byte aligned bases and rows of a multiple of 16 bytes
// (C % 4 == 0 in fp32, C % 8 == 0 in bf16); a channel tail and a partial
// last tile read zeros and their stores are skipped.
//
// rg_lru_kernel (the generic route, the port's first kernel): one thread
// per (batch, channel) prefetches 16 steps of a and b into registers while
// it runs the current 16. It takes any contiguous input, but with only
// B * C threads it keeps about 0.5 MB in flight at [1, 4096, 4096] and
// latency holds it at about a quarter of its bound.
//
// Plain C interface, loaded with ctypes. The entry point launches on the
// caller's stream, does not synchronise, and returns cudaGetLastError().

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "ptx.cuh"

namespace {

constexpr int U = 16;        // steps fetched ahead (generic route)
constexpr int NTHREAD = 32;  // one warp per block: 32 channels

// the ring (TMA route): of the tiles timed against each other on the
// H100 (16 or 32 channels, 16-64 steps, 3-12 stages), the fastest at both
// RecurrentGemma-9B shapes
constexpr int CB = 32;         // channels a block: a 128-byte row in fp32
constexpr int TS = 32;         // steps a tile
constexpr int NST = 6;         // tiles in the ring
constexpr int TILE = TS * CB;  // elements of one array in a stage
constexpr int UT = 16;         // steps read ahead of the chain
static_assert(CB == 32, "a lane of the consumer warp walks each channel");

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
    return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
    return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f(float x) {
    return __float2bfloat16(x);  // round to nearest even, as torch's cast
}

template <typename T>
__global__ void __launch_bounds__(NTHREAD)
rg_lru_kernel(const T* __restrict__ a, const T* __restrict__ b,
              T* __restrict__ y, int S, int C) {
    const int c = blockIdx.x * NTHREAD + threadIdx.x;
    if (c >= C) return;
    const size_t base = (size_t)blockIdx.y * S * C + c;
    float ca[U], cb[U], na[U], nb[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
        ca[u] = u < S ? to_f(a[base + (size_t)u * C]) : 0.f;
        cb[u] = u < S ? to_f(b[base + (size_t)u * C]) : 0.f;
    }
    float h = 0.f;
    for (int t0 = 0; t0 < S; t0 += U) {
#pragma unroll
        for (int u = 0; u < U; ++u) {
            const int t = t0 + U + u;
            na[u] = t < S ? to_f(a[base + (size_t)t * C]) : 0.f;
            nb[u] = t < S ? to_f(b[base + (size_t)t * C]) : 0.f;
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
            const int t = t0 + u;
            if (t < S) {
                h = __fadd_rn(__fmul_rn(ca[u], h), cb[u]);
                y[base + (size_t)t * C] = from_f<T>(h);
            }
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
            ca[u] = na[u];
            cb[u] = nb[u];
        }
    }
}

// a box of a 3-d tensor map into shared memory, completing on `bar`;
// coordinates (innermost first) outside the tensor read as zeros
__device__ __forceinline__ void tma_load_3d(void* dst, const void* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
    asm volatile(
        "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
        "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(ptx::smem_addr(dst)),
        "l"(map), "r"(c0), "r"(c1), "r"(c2), "r"(ptx::smem_addr(bar))
        : "memory");
}

// Warp 0 consumes, lane 0 of warp 1 produces. Tile k of the block's
// channels c0 .. c0 + CB - 1 (steps k * TS ..) goes to stage k % NST.
template <typename T>
__global__ void __launch_bounds__(64)
rg_lru_tma_kernel(const __grid_constant__ CUtensorMap tm_a,
                  const __grid_constant__ CUtensorMap tm_b,
                  T* __restrict__ y, int S, int C, int n_cb) {
    extern __shared__ __align__(128) unsigned char smem_raw[];
    T* sa = reinterpret_cast<T*>(smem_raw);
    T* sb = sa + NST * TILE;
    uint64_t* full = reinterpret_cast<uint64_t*>(sb + NST * TILE);
    uint64_t* empty = full + NST;
    const int c0 = (int)(blockIdx.x % n_cb) * CB;
    const int b = (int)(blockIdx.x / n_cb);
    const int n_tiles = (S + TS - 1) / TS;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    if (threadIdx.x == 0) {
        for (int s = 0; s < NST; ++s) {
            ptx::mbar_init(full + s, 1);
            ptx::mbar_init(empty + s, 1);
        }
        ptx::mbar_fence_init();
    }
    __syncthreads();

    if (warp == 1) {
        // producer: refill a stage once the consumer has released it
        if (lane == 0) {
            for (int k = 0; k < n_tiles; ++k) {
                const int s = k % NST;
                if (k >= NST) ptx::mbar_wait(empty + s, (k / NST - 1) & 1);
                ptx::mbar_arrive_expect_tx(full + s, 2 * TILE * sizeof(T));
                tma_load_3d(sa + s * TILE, &tm_a, full + s, c0, k * TS, b);
                tma_load_3d(sb + s * TILE, &tm_b, full + s, c0, k * TS, b);
            }
        }
        return;
    }

    // consumer: a lane walks channel c0 + lane
    const bool store = c0 + lane < C;
    T* yb = y + (size_t)b * S * C + c0 + lane;
    float h = 0.f;
    for (int k = 0; k < n_tiles; ++k) {
        const int s = k % NST;
        ptx::mbar_wait(full + s, (k / NST) & 1);
        const int off = s * TILE + lane;
        const T* ta = sa + off;
        const T* tb = sb + off;
        T* yk = yb + (size_t)k * TS * C;
        const int n = min(TS, S - k * TS);
        if (n == TS) {
#pragma unroll
            for (int t0 = 0; t0 < TS; t0 += UT) {
                float av[UT], bv[UT];
#pragma unroll
                for (int u = 0; u < UT; ++u) {
                    av[u] = to_f(ta[(t0 + u) * CB]);
                    bv[u] = to_f(tb[(t0 + u) * CB]);
                }
#pragma unroll
                for (int u = 0; u < UT; ++u) {
                    h = __fadd_rn(__fmul_rn(av[u], h), bv[u]);
                    if (store) yk[(size_t)(t0 + u) * C] = from_f<T>(h);
                }
            }
        } else {
            for (int t = 0; t < n; ++t) {
                h = __fadd_rn(__fmul_rn(to_f(ta[t * CB]), h),
                              to_f(tb[t * CB]));
                if (store) yk[(size_t)t * C] = from_f<T>(h);
            }
        }
        __syncwarp();  // every lane's reads of the stage are done
        if (lane == 0) ptx::mbar_arrive(empty + s);
    }
}

template <typename T>
int launch_generic(const void* a, const void* b, void* y, int B, int S,
                   int C, cudaStream_t stream) {
    if (B > 65535) return (int)cudaErrorInvalidValue;
    dim3 grid((C + NTHREAD - 1) / NTHREAD, B);
    rg_lru_kernel<T><<<grid, NTHREAD, 0, stream>>>(
        (const T*)a, (const T*)b, (T*)y, S, C);
    return (int)cudaGetLastError();
}

// x [B, S, C] as a 3-d tensor map, boxes of CB channels x TS steps of one
// batch row, no swizzle, zeros outside
template <typename T>
bool tensor_map_3d(CUtensorMap* map, const void* x, int B, int S, int C) {
    ptx::EncodeTiled enc = ptx::encode_tiled();
    if (!enc) return false;
    const CUtensorMapDataType dt = sizeof(T) == 2
                                       ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                       : CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
    const cuuint64_t dims[3] = {(cuuint64_t)C, (cuuint64_t)S, (cuuint64_t)B};
    const cuuint64_t strides[2] = {(cuuint64_t)C * sizeof(T),
                                   (cuuint64_t)S * C * sizeof(T)};
    const cuuint32_t box[3] = {(cuuint32_t)CB, (cuuint32_t)TS, 1};
    const cuuint32_t estr[3] = {1, 1, 1};
    return enc(map, dt, 3, const_cast<void*>(x), dims, strides, box, estr,
               CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
               CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename T>
int launch_tma(const void* a, const void* b, void* y, int B, int S, int C,
               cudaStream_t stream) {
    // TMA's rules: 16-byte aligned bases, rows a multiple of 16 bytes
    if ((((uintptr_t)a | (uintptr_t)b) & 15) || (C * sizeof(T)) % 16)
        return (int)cudaErrorInvalidValue;
    CUtensorMap ta{}, tb{};
    if (!(tensor_map_3d<T>(&ta, a, B, S, C) &&
          tensor_map_3d<T>(&tb, b, B, S, C)))
        return (int)cudaErrorInvalidValue;
    const int n_cb = (C + CB - 1) / CB;
    const long long blocks = (long long)n_cb * B;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    const size_t smem = 2 * NST * TILE * sizeof(T) + 2 * NST * sizeof(uint64_t);
    auto kern = rg_lru_tma_kernel<T>;
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    kern<<<(unsigned)blocks, 64, smem, stream>>>(ta, tb, (T*)y, S, C, n_cb);
    return (int)cudaGetLastError();
}

}  // namespace

// a, b, y [B, S, C], contiguous, fp32 (is_bf16 = 0) or bf16 (is_bf16 = 1);
// tma = 1 takes the TMA ring (refused unless a and b are 16-byte aligned
// and C's rows a multiple of 16 bytes), tma = 0 the generic kernel (B at
// most 65535).
extern "C" int rg_lru_launch(const void* a, const void* b, void* y, int B,
                             int S, int C, int is_bf16, int tma,
                             void* stream) {
    if (B < 1 || S < 1 || C < 1) return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    if (tma)
        return is_bf16 ? launch_tma<__nv_bfloat16>(a, b, y, B, S, C, st)
                       : launch_tma<float>(a, b, y, B, S, C, st);
    return is_bf16 ? launch_generic<__nv_bfloat16>(a, b, y, B, S, C, st)
                   : launch_generic<float>(a, b, y, B, S, C, st);
}
