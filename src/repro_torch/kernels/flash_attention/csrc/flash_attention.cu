// Flash attention forward for Hopper (sm_90a).
//
// Replaces the TPU Pallas kernel repro/kernels/flash_attention/kernel.py::
// flash_attention_fwd (kernel.py:84, pallas_call at :103): causal GQA
// attention with an optional sliding window and tanh logit softcap, online
// softmax with m, l and the accumulator in fp32, output in q's dtype. It is
// held to the plain version repro_torch/kernels/flash_attention/ref.py.
//
// What bounds it on the H100. At RecurrentGemma-9B's local layers (B = 1,
// S = 4096, H = 16 query heads over K = 1 KV head, Dh = 256, window 2048)
// the band holds about 1.0e8 (query, key) pairs per call, 4 * Dh = 1024
// FLOP each: 1.03e11 FLOP, 104 us at the 989 TFLOP/s bf16 tensor-core
// rate, while the bytes (q, k, v, o: 35 MB) take 10 us. So operations bound
// it, and only tensor cores (wgmma, fed by TMA) reach that bound.
//
// What this design does about it: nothing yet, on purpose. It is the
// simple kernel that is right, on the CUDA cores in fp32:
//   * one block of 8 warps per (batch, query head, 64-row query tile);
//     query head h reads KV head h / (H / K), the reference's
//     [B, S, K, G, Dh] grouping;
//   * the Q tile and one 32-key K/V tile sit in dynamic shared memory as
//     fp32 (139 KB at Dh = 256, above the 48 KB default, hence
//     cudaFuncSetAttribute);
//   * the loop runs only over the KV tiles that meet the band
//     [q - W + 1, q] of the tile's rows; the Pallas kernel visits every
//     tile and masks the rest to -1e30, which adds exactly zero;
//   * each warp owns 8 query rows; lane c scores key c of the tile, so a
//     row's max and sum are warp shuffles, and the probabilities go
//     through shared memory to the P.V product, where lane c owns output
//     columns c, c + 32, ...;
//   * masked scores are -inf and a row that has seen only masked keys
//     keeps m = -inf and adds nothing, so masked keys contribute exactly
//     zero as in the plain version; rows and keys past S (the ragged edge)
//     are masked, and any S >= 1 is taken.
// Its time stands beside the bound in PERF.md. Tensor cores, wgmma and
// TMA are later work.
//
// Plain C interface, loaded with ctypes. The entry point launches on the
// caller's stream, does not synchronise, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;              // query rows per block
constexpr int BK = 32;              // keys per tile: one per lane
constexpr int NWARP = 8;
constexpr int NTHREAD = NWARP * 32;
constexpr int ROWS = BQ / NWARP;    // query rows per warp
constexpr unsigned FULL = 0xffffffffu;

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

// NJ = output columns per lane: Dh <= 32 * NJ.
template <typename T, int NJ>
__global__ void __launch_bounds__(NTHREAD)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int S, int H,
                 int KH, int Dh, int causal, int window, float softcap,
                 float sqrt_dh) {
    extern __shared__ float smem[];
    const int ldk = Dh + 1;              // odd stride: lanes hit distinct banks
    float* sQ = smem;                    // [BQ][Dh]
    float* sK = sQ + BQ * Dh;            // [BK][Dh + 1]
    float* sV = sK + BK * ldk;           // [BK][Dh]
    float* sP = sV + BK * Dh;            // [BQ][BK]

    const int q0 = blockIdx.x * BQ;
    const int h = blockIdx.y;
    const int b = blockIdx.z;
    const int kh = h / (H / KH);
    const int tid = threadIdx.x;
    const int warp = tid >> 5;
    const int lane = tid & 31;
    const int q_last = min(q0 + BQ, S) - 1;

    for (int i = tid; i < BQ * Dh; i += NTHREAD) {
        const int r = i / Dh, d = i - r * Dh, qi = q0 + r;
        sQ[i] = qi < S ? to_f(q[(((size_t)b * S + qi) * H + h) * Dh + d])
                       : 0.f;
    }

    float acc[ROWS][NJ];
    float m[ROWS], l[ROWS];
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
        m[i] = -INFINITY;
        l[i] = 0.f;
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
    }

    // KV tiles that meet the band of rows q0 .. q_last
    const int kv_lo = window ? max(0, q0 - window + 1) : 0;
    const int kv_hi = causal ? q_last + 1 : S;       // exclusive
    const int t_lo = kv_lo / BK;
    const int t_hi = (kv_hi + BK - 1) / BK;

    for (int t = t_lo; t < t_hi; ++t) {
        const int k0 = t * BK;
        __syncthreads();                 // the last tile's readers are done
        for (int i = tid; i < BK * Dh; i += NTHREAD) {
            const int r = i / Dh, d = i - r * Dh, kj = k0 + r;
            const size_t off = (((size_t)b * S + kj) * KH + kh) * Dh + d;
            sK[r * ldk + d] = kj < S ? to_f(k[off]) : 0.f;
            sV[r * Dh + d] = kj < S ? to_f(v[off]) : 0.f;
        }
        __syncthreads();

        // scores of this warp's rows against key k0 + lane
        float s[ROWS];
#pragma unroll
        for (int i = 0; i < ROWS; ++i) s[i] = 0.f;
        const float* kr = sK + lane * ldk;
        for (int d = 0; d < Dh; ++d) {
            const float kd = kr[d];
#pragma unroll
            for (int i = 0; i < ROWS; ++i)
                s[i] = fmaf(sQ[(warp + NWARP * i) * Dh + d], kd, s[i]);
        }

        const int kj = k0 + lane;
#pragma unroll
        for (int i = 0; i < ROWS; ++i) {
            const int row = warp + NWARP * i;
            const int qi = q0 + row;
            float x = s[i] / sqrt_dh;
            if (softcap != 0.f) x = tanhf(x / softcap) * softcap;
            bool ok = kj < S && qi < S;
            if (causal) ok = ok && kj <= qi;
            if (window) ok = ok && kj > qi - window;
            x = ok ? x : -INFINITY;

            float mx = x;
#pragma unroll
            for (int off = 16; off > 0; off >>= 1)
                mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, off));
            const float m_new = fmaxf(m[i], mx);
            float p = 0.f, alpha = 1.f;
            if (m_new != -INFINITY) {    // some key of this row is live
                p = expf(x - m_new);     // 0 for a masked key
                alpha = expf(m[i] - m_new);
            }
            float ps = p;
#pragma unroll
            for (int off = 16; off > 0; off >>= 1)
                ps += __shfl_xor_sync(FULL, ps, off);
            l[i] = l[i] * alpha + ps;
            m[i] = m_new;
#pragma unroll
            for (int j = 0; j < NJ; ++j) acc[i][j] *= alpha;
            sP[row * BK + lane] = p;
        }
        __syncwarp();                    // each warp reads only its own rows

        for (int c = 0; c < BK; ++c) {
            float vv[NJ];
#pragma unroll
            for (int j = 0; j < NJ; ++j) {
                const int d = lane + 32 * j;
                vv[j] = d < Dh ? sV[c * Dh + d] : 0.f;
            }
#pragma unroll
            for (int i = 0; i < ROWS; ++i) {
                const float p = sP[(warp + NWARP * i) * BK + c];
#pragma unroll
                for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(p, vv[j], acc[i][j]);
            }
        }
    }

#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
        const int qi = q0 + warp + NWARP * i;
        if (qi >= S) continue;
        const float denom = fmaxf(l[i], 1e-20f);
        T* orow = o + (((size_t)b * S + qi) * H + h) * Dh;
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
            const int d = lane + 32 * j;
            if (d < Dh) orow[d] = from_f<T>(acc[i][j] / denom);
        }
    }
}

template <typename T, int NJ>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int S, int H, int KH, int Dh, int causal, int window,
           float softcap, float sqrt_dh, cudaStream_t stream) {
    const size_t smem =
        sizeof(float) * ((size_t)BQ * Dh + (size_t)BK * (Dh + 1) +
                         (size_t)BK * Dh + (size_t)BQ * BK);
    auto kern = flash_fwd_kernel<T, NJ>;
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    dim3 grid((S + BQ - 1) / BQ, H, B);
    kern<<<grid, NTHREAD, smem, stream>>>(
        (const T*)q, (const T*)k, (const T*)v, (T*)o, S, H, KH, Dh, causal,
        window, softcap, sqrt_dh);
    return (int)cudaGetLastError();
}

template <typename T>
int launch_dh(const void* q, const void* k, const void* v, void* o, int B,
              int S, int H, int KH, int Dh, int causal, int window,
              float softcap, float sqrt_dh, cudaStream_t stream) {
    if (Dh <= 32)
        return launch<T, 1>(q, k, v, o, B, S, H, KH, Dh, causal, window,
                            softcap, sqrt_dh, stream);
    if (Dh <= 64)
        return launch<T, 2>(q, k, v, o, B, S, H, KH, Dh, causal, window,
                            softcap, sqrt_dh, stream);
    if (Dh <= 128)
        return launch<T, 4>(q, k, v, o, B, S, H, KH, Dh, causal, window,
                            softcap, sqrt_dh, stream);
    return launch<T, 8>(q, k, v, o, B, S, H, KH, Dh, causal, window,
                        softcap, sqrt_dh, stream);
}

}  // namespace

// q [B, S, H, Dh], k/v [B, S, KH, Dh] -> o [B, S, H, Dh], all contiguous,
// fp32 (is_bf16 = 0) or bf16 (is_bf16 = 1). 1 <= Dh <= 256, H % KH == 0.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int B, int S,
                                      int H, int KH, int Dh, int causal,
                                      int window, float softcap,
                                      float sqrt_dh, int is_bf16,
                                      void* stream) {
    if (Dh < 1 || Dh > 256 || KH < 1 || H % KH != 0 || S < 1 || B < 1)
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    if (is_bf16)
        return launch_dh<__nv_bfloat16>(q, k, v, o, B, S, H, KH, Dh, causal,
                                        window, softcap, sqrt_dh, st);
    return launch_dh<float>(q, k, v, o, B, S, H, KH, Dh, causal, window,
                            softcap, sqrt_dh, st);
}
