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
// What this design does about it: one thread per (batch, channel) walks t,
// so the 32 lanes of a warp read 32 neighbouring channels, 128 contiguous
// bytes, at every step. The loads do not depend on h, so each thread
// fetches the next 16 steps of a and b into registers while it runs the
// current 16: the dependent chain is two rounded operations a step, and
// the memory latency is paid once per 16 steps. With only B * C = 4096
// threads (128 one-warp blocks, one per SM) the card cannot hold enough
// bytes in flight to reach its bandwidth: latency, not bytes, bounds this
// kernel, far above its 60 us bound. Splitting t into chunks scanned in
// parallel (a second pass carries the chunk boundaries) is later work.
//
// Plain C interface, loaded with ctypes. The entry point launches on the
// caller's stream, does not synchronise, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int U = 16;        // steps fetched ahead
constexpr int NTHREAD = 32;  // one warp per block: 32 channels

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

template <typename T>
int launch(const void* a, const void* b, void* y, int B, int S, int C,
           cudaStream_t stream) {
    dim3 grid((C + NTHREAD - 1) / NTHREAD, B);
    rg_lru_kernel<T><<<grid, NTHREAD, 0, stream>>>(
        (const T*)a, (const T*)b, (T*)y, S, C);
    return (int)cudaGetLastError();
}

}  // namespace

// a, b, y [B, S, C], contiguous, fp32 (is_bf16 = 0) or bf16 (is_bf16 = 1).
extern "C" int rg_lru_launch(const void* a, const void* b, void* y, int B,
                             int S, int C, int is_bf16, void* stream) {
    if (B < 1 || S < 1 || C < 1 || B > 65535)
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    if (is_bf16) return launch<__nv_bfloat16>(a, b, y, B, S, C, st);
    return launch<float>(a, b, y, B, S, C, st);
}
