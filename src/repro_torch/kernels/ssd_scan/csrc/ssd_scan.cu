// Mamba-2 SSD chunked scan for Hopper (sm_90a).
//
// Replaces the TPU Pallas kernel repro/kernels/ssd_scan/kernel.py::ssd_fwd
// (kernel.py:65, pallas_call at :79). Per (batch, head), over chunks of Q
// steps taken in order, from a zero state h [N, P]:
//   cum   = cumsum(dt * A) within the chunk
//   y     = (C B^T (.) L)(dt x) + (C exp(cum)) h,   L_ij = exp(cum_i - cum_j)
//           for j <= i, else 0
//   h     = exp(cum_end) h + (B exp(cum_end - cum))^T (dt x)
// with fp32 arithmetic, y in x's dtype and h_last in fp32. It is held to
// the plain version repro_torch/kernels/ssd_scan/ref.py (the sequential
// recurrence h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t^T, y_t = C_t h_t).
//
// Unlike the TPU kernel, B and C come in per group, [B, S, G, N]: head h
// reads group h / (H / G). The reference repeats them to every head
// before the call, which at Mamba-2 780M's scoring shape makes two 201 MB
// copies of 2 MB of data.
//
// What bounds it on the H100. The work is the causal half only, per
// (batch, head, chunk) Q (Q + 1) N FLOP for C B^T on j <= i, Q (Q + 1) P
// for the masked scores times x, and 4 Q N P for C h and the state
// update. At [4, 4096, 48, 64], N 128, Q 128 in bf16 that is 13.0 GFLOP
// of C B^T, a product of bf16 inputs (13 us at the 989 TFLOP/s bf16
// tensor-core rate, exact with fp32 accumulation), and 32.3 GFLOP of
// products of fp32 values (0.48 ms at the 67 TFLOP/s fp32 rate; 65 us at
// the 495 TFLOP/s TF32 rate); the sequential recurrence would need
// 5 N P FLOP a token, 32.2 GFLOP. Bytes: 219 MB (x, y, dt, grouped B and
// C, h_last), 65 us at 3.35 TB/s. So operations bound it, at 0.49 ms.
//
// What this design does about it: it is the simple kernel that is right,
// on the CUDA cores in fp32.
//   * One block of 256 threads per (P-slice of 32 state columns, head,
//     batch). The state's columns are independent (y[:, p] needs only
//     x[:, p] and h[:, p]), so at P = 64 two blocks share a head and each
//     recomputes C B^T: 384 blocks at batch 4 instead of 192 on 132 SMs
//     (three even waves instead of one and a half), for about 25% more
//     operations than one block per head.
//   * A chunk's B and C rows ([Q, N] each, fp32) and x slice sit in
//     dynamic shared memory with the state [N, 32] and the masked scores
//     [Q, Q]; the scores reuse C's buffer once C is read. That is 169 KB
//     at Q = N = 128, above the 48 KB default, hence cudaFuncSetAttribute.
//     Rows are padded by 4 floats so that the float4 reads of the
//     register tiles below do not collide in a bank.
//   * The products are register-tiled: C B^T in 8 x 8 tiles of rows
//     strided by Q / 8, of which only the tiles on or below the diagonal
//     are computed; the outputs and the state update in 4 x 4 tiles.
//     exp() is taken only where j <= i, so the masked half (where
//     cum_i - cum_j > 0 could overflow) is never evaluated.
//   * dt is folded into the scores' columns (dt_j) and into the state
//     update's weights (dt_j exp(cum_end - cum_j)).
//   * Any Q from 1 to 128 that divides S, any N up to 128 and any P:
//     tiles are padded with zeros and masked on the way out.
// Tensor cores (wgmma on TF32 or bf16 tiles), TMA loads and overlapping
// the next chunk's loads with this chunk's products are later work.
//
// Plain C interface, loaded with ctypes. The entry point launches on the
// caller's stream, does not synchronise, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NTHREAD = 256;
constexpr int MAX_Q = 128;
constexpr int MAX_N = 128;
constexpr int MAX_PS = 32;            // state columns per block
constexpr int LU = 16;                // loads in flight per thread
constexpr int SMEM_LIMIT = 232448;    // a block's dynamic shared memory
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

__device__ __forceinline__ void unpack(const float* p, float v[4]) {
    const float4 f = *reinterpret_cast<const float4*>(p);
    v[0] = f.x; v[1] = f.y; v[2] = f.z; v[3] = f.w;
}

struct Geom {
    int Qp, Np, PS, LDN, LDM, LDC;
    __host__ __device__ Geom(int Q, int N, int P) {
        Qp = (Q + 7) & ~7;                 // rows, padded for 8 x 8 tiles
        Np = (N + 3) & ~3;                 // state rows, padded for float4
        PS = (P + 3) & ~3;                 // state columns per block
        if (PS > MAX_PS) PS = MAX_PS;
        LDN = Np + 4;                      // row stride of B and C
        LDM = Qp + 4;                      // row stride of the scores
        LDC = LDN > LDM ? LDN : LDM;       // C's buffer, then the scores'
    }
    __host__ __device__ size_t floats() const {
        return (size_t)Qp * LDN + (size_t)Qp * LDC + (size_t)Qp * PS
               + (size_t)Np * PS + 3 * (size_t)Qp;
    }
};

// x, y [B, S, H, P]; dt [B, S, H]; A [H]; Bg, Cg [B, S, G, N];
// hlast [B, H, N, P]. Grid (P slices, H, B).
template <typename T>
__global__ void __launch_bounds__(NTHREAD, 1)
ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const T* __restrict__ Bg,
                const T* __restrict__ Cg, T* __restrict__ y,
                float* __restrict__ hlast, int S, int H, int P, int G,
                int N, int Q) {
    const Geom gm(Q, N, P);
    const int Qp = gm.Qp, Np = gm.Np, PS = gm.PS, LDN = gm.LDN,
              LDM = gm.LDM;
    const int p0 = blockIdx.x * PS;
    const int h = blockIdx.y;
    const int b = blockIdx.z;
    const int g = h / (H / G);
    const int tid = threadIdx.x;

    extern __shared__ float4 smem4[];
    float* Bs = reinterpret_cast<float*>(smem4);   // [Qp][LDN]
    float* CM = Bs + (size_t)Qp * LDN;             // C, then the scores M
    float* Xs = CM + (size_t)Qp * gm.LDC;          // [Qp][PS]
    float* Hs = Xs + (size_t)Qp * PS;              // [Np][PS]
    float* cum = Hs + (size_t)Np * PS;             // [Qp]
    float* Wd = cum + Qp;                          // dt_j exp(cum_end - cum_j)
    float* dtv = Wd + Qp;                          // dt_j
    const float a_h = A[h];

    // thread tiles: scores (R1 x R1 tiles of 8 x 8), outputs (RS x PT of
    // 4 x 4), state (NT x PT of 4 x 4)
    const int R1 = Qp / 8, RS = Qp / 4, PT = PS / 4, NT = Np / 4;
    const bool act1 = tid < R1 * R1;
    const int ti = tid / R1, tj = tid - (tid / R1) * R1;
    const bool act2 = tid < RS * PT;
    const int it = tid / PT, pt = tid - (tid / PT) * PT;
    const bool act3 = tid < NT * PT;
    const int nt = it;                             // same split as it, pt

    for (int i = tid; i < Np * PS; i += NTHREAD) Hs[i] = 0.f;

    const int nc = S / Q;
    for (int c = 0; c < nc; ++c) {
        const size_t row0 = (size_t)b * S + (size_t)c * Q;
        __syncthreads();  // the previous chunk is done with every buffer

        // ---- load B, C (zero past Q and N), x's slice and dt ----------
        for (int base = 0; base < Qp * Np; base += NTHREAD * LU) {
            float vb[LU], vc[LU];
#pragma unroll
            for (int u = 0; u < LU; ++u) {
                const int idx = base + u * NTHREAD + tid;
                const int j = idx / Np, n = idx - (idx / Np) * Np;
                vb[u] = 0.f;
                vc[u] = 0.f;
                if (idx < Qp * Np && j < Q && n < N) {
                    const size_t off = ((row0 + j) * G + g) * N + n;
                    vb[u] = to_f(Bg[off]);
                    vc[u] = to_f(Cg[off]);
                }
            }
#pragma unroll
            for (int u = 0; u < LU; ++u) {
                const int idx = base + u * NTHREAD + tid;
                if (idx < Qp * Np) {
                    const int j = idx / Np, n = idx - (idx / Np) * Np;
                    Bs[j * LDN + n] = vb[u];
                    CM[j * LDN + n] = vc[u];
                }
            }
        }
        for (int base = 0; base < Qp * PS; base += NTHREAD * LU) {
            float vx[LU];
#pragma unroll
            for (int u = 0; u < LU; ++u) {
                const int idx = base + u * NTHREAD + tid;
                const int j = idx / PS, p = idx - (idx / PS) * PS;
                vx[u] = 0.f;
                if (idx < Qp * PS && j < Q && p0 + p < P)
                    vx[u] = to_f(x[((row0 + j) * H + h) * P + p0 + p]);
            }
#pragma unroll
            for (int u = 0; u < LU; ++u) {
                const int idx = base + u * NTHREAD + tid;
                if (idx < Qp * PS) Xs[idx] = vx[u];
            }
        }
        if (tid < 32) {
            // within-chunk cumsum of dt * A: lane l holds rows 4l .. 4l+3
            // (Qp <= 128), then a warp scan of the lanes' totals
            float d[4], loc[4], run = 0.f;
#pragma unroll
            for (int k = 0; k < 4; ++k) {
                const int j = tid * 4 + k;
                d[k] = j < Q ? dt[(row0 + j) * H + h] : 0.f;
                run += d[k] * a_h;
                loc[k] = run;
            }
            float incl = run;
#pragma unroll
            for (int off = 1; off < 32; off <<= 1) {
                const float v = __shfl_up_sync(FULL, incl, off);
                if (tid >= off) incl += v;
            }
            const float excl = incl - run;
#pragma unroll
            for (int k = 0; k < 4; ++k) {
                const int j = tid * 4 + k;
                if (j < Qp) {
                    cum[j] = excl + loc[k];
                    dtv[j] = d[k];
                }
            }
            __syncwarp();
            const float cend = cum[Q - 1];
#pragma unroll
            for (int k = 0; k < 4; ++k) {
                const int j = tid * 4 + k;
                if (j < Qp) Wd[j] = j < Q ? expf(cend - cum[j]) * d[k] : 0.f;
            }
        }
        __syncthreads();

        // ---- inter-chunk term: yi = C h (the state entering the chunk) --
        float yi[4][4], ya[4][4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int q = 0; q < 4; ++q) yi[r][q] = ya[r][q] = 0.f;
        if (act2) {
            for (int n = 0; n < Np; n += 4) {
                float hv[4][4];
#pragma unroll
                for (int k = 0; k < 4; ++k)
                    unpack(&Hs[(n + k) * PS + pt * 4], hv[k]);
#pragma unroll
                for (int r = 0; r < 4; ++r) {
                    float cv[4];
                    unpack(&CM[(it + RS * r) * LDN + n], cv);
#pragma unroll
                    for (int k = 0; k < 4; ++k)
#pragma unroll
                        for (int q = 0; q < 4; ++q)
                            yi[r][q] = fmaf(cv[k], hv[k][q], yi[r][q]);
                }
            }
        }

        // ---- scores C B^T, lower-triangular 8 x 8 tiles ----------------
        float m[8][8];
#pragma unroll
        for (int r = 0; r < 8; ++r)
#pragma unroll
            for (int s = 0; s < 8; ++s) m[r][s] = 0.f;
        if (act1) {
            for (int n = 0; n < Np; n += 4) {
                float cv[8][4];
#pragma unroll
                for (int r = 0; r < 8; ++r)
                    unpack(&CM[(ti + R1 * r) * LDN + n], cv[r]);
#pragma unroll
                for (int s = 0; s < 8; ++s) {
                    float bv[4];
                    unpack(&Bs[(tj + R1 * s) * LDN + n], bv);
                    // row ti + R1 r >= column tj + R1 s needs s <= r
#pragma unroll
                    for (int r = s; r < 8; ++r)
#pragma unroll
                        for (int k = 0; k < 4; ++k)
                            m[r][s] = fmaf(cv[r][k], bv[k], m[r][s]);
                }
            }
        }
        __syncthreads();  // every thread is done reading C

        // ---- masked scores M_ij = (C B^T)_ij L_ij dt_j into C's buffer --
        if (act1) {
#pragma unroll
            for (int r = 0; r < 8; ++r) {
                const int i = ti + R1 * r;
#pragma unroll
                for (int s = 0; s < 8; ++s) {
                    const int j = tj + R1 * s;
                    float v = 0.f;
                    if (s <= r && j <= i && i < Q)
                        v = m[r][s] * expf(cum[i] - cum[j]) * dtv[j];
                    CM[i * LDM + j] = v;
                }
            }
        }
        // ---- state update: h = exp(cum_end) h + sum_j B_j Wd_j x_j -----
        if (act3) {
            float acc[4][4];
#pragma unroll
            for (int r = 0; r < 4; ++r)
#pragma unroll
                for (int q = 0; q < 4; ++q) acc[r][q] = 0.f;
            for (int j = 0; j < Q; ++j) {
                float bv[4], xv[4];
                unpack(&Bs[j * LDN + nt * 4], bv);
                unpack(&Xs[j * PS + pt * 4], xv);
                const float w = Wd[j];
#pragma unroll
                for (int r = 0; r < 4; ++r) {
                    const float bw = bv[r] * w;
#pragma unroll
                    for (int q = 0; q < 4; ++q)
                        acc[r][q] = fmaf(bw, xv[q], acc[r][q]);
                }
            }
            const float aend = expf(cum[Q - 1]);
#pragma unroll
            for (int r = 0; r < 4; ++r)
#pragma unroll
                for (int q = 0; q < 4; ++q) {
                    float* hp = &Hs[(nt * 4 + r) * PS + pt * 4 + q];
                    *hp = fmaf(aend, *hp, acc[r][q]);
                }
        }
        __syncthreads();  // the scores are written

        // ---- intra-chunk term ya = M x, then y = ya + exp(cum_i) yi -----
        if (act2) {
            const int jmax = min(Qp, (it + 3 * RS + 4) & ~3);
            for (int j = 0; j < jmax; j += 4) {
                float xv[4][4];
#pragma unroll
                for (int k = 0; k < 4; ++k)
                    unpack(&Xs[(j + k) * PS + pt * 4], xv[k]);
#pragma unroll
                for (int r = 0; r < 4; ++r) {
                    float mv[4];
                    unpack(&CM[(it + RS * r) * LDM + j], mv);
#pragma unroll
                    for (int k = 0; k < 4; ++k)
#pragma unroll
                        for (int q = 0; q < 4; ++q)
                            ya[r][q] = fmaf(mv[k], xv[k][q], ya[r][q]);
                }
            }
#pragma unroll
            for (int r = 0; r < 4; ++r) {
                const int i = it + RS * r;
                if (i >= Q) continue;
                const float ed = expf(cum[i]);
                T* yrow = y + ((row0 + i) * H + h) * P + p0 + pt * 4;
#pragma unroll
                for (int q = 0; q < 4; ++q)
                    if (p0 + pt * 4 + q < P)
                        yrow[q] = from_f<T>(fmaf(ed, yi[r][q], ya[r][q]));
            }
        }
    }
    __syncthreads();
    for (int idx = tid; idx < N * PS; idx += NTHREAD) {
        const int n = idx / PS, p = idx - (idx / PS) * PS;
        if (p0 + p < P)
            hlast[(((size_t)b * H + h) * N + n) * P + p0 + p] = Hs[n * PS + p];
    }
}

template <typename T>
int launch(const void* x, const void* dt, const void* A, const void* Bg,
           const void* Cg, void* y, void* hlast, int B, int S, int H, int P,
           int G, int N, int Q, cudaStream_t stream) {
    const Geom gm(Q, N, P);
    const size_t smem = gm.floats() * sizeof(float);
    if (smem > (size_t)SMEM_LIMIT) return (int)cudaErrorInvalidValue;
    auto kern = ssd_scan_kernel<T>;
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    dim3 grid((P + gm.PS - 1) / gm.PS, H, B);
    kern<<<grid, NTHREAD, smem, stream>>>(
        (const T*)x, (const float*)dt, (const float*)A, (const T*)Bg,
        (const T*)Cg, (T*)y, (float*)hlast, S, H, P, G, N, Q);
    return (int)cudaGetLastError();
}

}  // namespace

// x, y [B, S, H, P], Bg, Cg [B, S, G, N], all fp32 (bf16 = 0) or all bf16
// (bf16 = 1); dt [B, S, H] fp32; A [H] fp32; hlast [B, H, N, P] fp32; all
// contiguous. 1 <= Q <= 128 divides S, N <= 128, G divides H.
extern "C" int ssd_scan_launch(const void* x, const void* dt, const void* A,
                               const void* Bg, const void* Cg, void* y,
                               void* hlast, int B, int S, int H, int P,
                               int G, int N, int Q, int bf16, void* stream) {
    if (B < 1 || S < 1 || H < 1 || P < 1 || G < 1 || N < 1 || Q < 1
        || Q > MAX_Q || N > MAX_N || S % Q != 0 || H % G != 0
        || B > 65535 || H > 65535)
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    if (bf16)
        return launch<__nv_bfloat16>(x, dt, A, Bg, Cg, y, hlast, B, S, H, P,
                                     G, N, Q, st);
    return launch<float>(x, dt, A, Bg, Cg, y, hlast, B, S, H, P, G, N, Q,
                         st);
}
