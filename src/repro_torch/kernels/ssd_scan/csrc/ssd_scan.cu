// Mamba-2 SSD chunked scan for Hopper (sm_90a).
//
// Replaces the TPU Pallas kernel repro/kernels/ssd_scan/kernel.py::ssd_fwd
// (kernel.py:65, pallas_call at :79). Per (batch, head), over chunks of Q
// steps taken in order, from a zero state h [N, P]:
//   cum   = cumsum(dt * A) within the chunk
//   y     = (C B^T (.) L)(dt x) + diag(exp(cum)) C h,   L_ij = exp(cum_i -
//           cum_j) for j <= i, else 0
//   h     = exp(cum_end) h + B^T (w (.) x),   w_j = dt_j exp(cum_end - cum_j)
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
// of C B^T on bf16 inputs and 32.3 GFLOP of products with one fp32
// operand. On the bf16 tensor cores (989 TFLOP/s), with each fp32 operand
// taken in two bf16 passes (below), that is 78.4 us; 219 MB of inputs and
// outputs take 65 us at 3.35 TB/s. So operations bound it, at 78.4 us.
//
// bf16 (every timed path): ssd_scan_wgmma_kernel, on the tensor cores.
//   * All four products are wgmma on bf16 with fp32 accumulators: S = C
//     B^T, M x, C h and B^T (w (.) x). B, C and x are bf16 inputs, exact.
//     Each fp32 operand (the masked scores M, the state h and w (.) x) is
//     split into bf16 hi + lo, hi = bf16(v), lo = bf16(v - hi), and
//     multiplied in two passes, which keeps y at its own bf16 rounding and
//     h_last at fp32 level (one pass costs 4x on y and about 600x on
//     h_last).
//   * One block per (32 state columns, head, batch): 384 blocks at the
//     path's shape, one a SM (214 KB of shared memory), each recomputing
//     C B^T for its half of P. Three warpgroups, which meet only on
//     mbarriers, so that only the state update waits for the previous
//     chunk and everything else runs beside it:
//       - y warpgroups 0 and 1, rows 64k .. 64k + 63 of the chunk: S on
//         the causal columns only (64, 128), C and B K-major from their
//         TMA tiles; C h once the state after the previous chunk is
//         written; M in registers; M x; y to memory. Warpgroup 0, with
//         half the scores, also writes x^T (K-major) for M x.
//       - the state warpgroup: the loads, w x^T (hi, lo), the state
//         update on all 128 state rows (A = B read MN-major, i.e. B^T),
//         the state as h^T hi and lo (K-major, the B operand of the next
//         chunk's C h, two sets), and, by its first warp, the next
//         chunk's dt, cumsum, w, column factors and exp(cum_end) (two
//         sets) while its products run.
//     The warpgroup index is taken warp-uniform (__shfl_sync), and C h
//     runs on every chunk (h^T is 0 before the first), so that no wgmma
//     sits on a divergent path: ptxas would serialise them.
//   * M never goes to shared memory: the accumulators of S, scaled by
//     exp(cum_i - cum_j) dt_j and split, are the register A fragments of
//     M x. exp is taken only where j <= i: on a warp's diagonal 16 x 16
//     tile per element, below it as exp(cum_i - cum_e) exp(cum_e - cum_j)
//     (e the tile's last column, both factors at most 1), two SFU exps a
//     row and a column factor from shared memory. C h has the row scale
//     exp(cum_i) applied to its accumulators in fp32 before M x adds in.
//   * Loads are TMA into two stages, 128-byte (B, C) and 64-byte (x)
//     swizzled, on one mbarrier a stage; chunk c + 1 is issued as soon as
//     the y warpgroups are done with chunk c - 1.
//   * Any Q from 1 to 128 that divides S (rows past Q zero), any N up to
//     128 (columns past N zero), any P (slices of 32, masked on the way
//     out); N or P not a multiple of 8, or unaligned pointers, load
//     element by element instead of by TMA.
//
// fp32: ssd_scan_kernel, the first CUDA-core kernel, unchanged. The fp32
// checks (chip_smoke.py, 1e-4 against the plain version, and a 3-layer
// fp32 model on the card against the CPU) need full fp32 products, which
// TF32 or bf16 products would miss; no timed path runs the scan in fp32.
// One block of 256 threads per (P-slice of 32 state columns, head,
// batch); the chunk's B, C, x slice, the state [N, 32] and the masked
// scores [Q, Q] sit in 169 KB of dynamic shared memory as fp32; the
// products are register-tiled on the CUDA cores (C B^T in 8 x 8 tiles of
// which only those on or below the diagonal are computed; the outputs and
// the state update in 4 x 4 tiles); exp() only where j <= i.
//
// Plain C interface, loaded with ctypes. The entry point launches on the
// caller's stream, does not synchronise, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "ptx.cuh"

namespace {

// ---------------------------------------------------------------------------
// fp32: CUDA cores
// ---------------------------------------------------------------------------
constexpr int NTHREAD = 256;
constexpr int MAX_Q = 128;
constexpr int MAX_N = 128;
constexpr int MAX_PS = 32;            // state columns per block
constexpr int LU = 16;                // loads in flight per thread
constexpr int SMEM_LIMIT = 232448;    // a block's dynamic shared memory
constexpr unsigned FULL = 0xffffffffu;

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
__global__ void __launch_bounds__(NTHREAD, 1)
ssd_scan_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const float* __restrict__ Bg,
                const float* __restrict__ Cg, float* __restrict__ y,
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
                    vb[u] = Bg[off];
                    vc[u] = Cg[off];
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
                    vx[u] = x[((row0 + j) * H + h) * P + p0 + p];
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
                float* yrow = y + ((row0 + i) * H + h) * P + p0 + pt * 4;
#pragma unroll
                for (int q = 0; q < 4; ++q)
                    if (p0 + pt * 4 + q < P)
                        yrow[q] = fmaf(ed, yi[r][q], ya[r][q]);
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


// ---------------------------------------------------------------------------
// bf16: tensor cores (wgmma, fp32 accumulators)
// ---------------------------------------------------------------------------
constexpr int TC_Q = 128;            // rows of a chunk tile (Q padded)
constexpr int TC_N = 128;            // state rows (N padded)
constexpr int TC_PS = 32;            // state columns per block
constexpr int TC_WARPS = 12;         // two warpgroups of 64 rows, one for h
constexpr int TC_THREADS = 32 * TC_WARPS;
constexpr int TC_BLOCKS_PER_SM = 1;
// shared memory, bytes, from a 1024-byte boundary: two stages (chunk c in
// stage c % 2) of C and B [TC_Q][TC_N] bf16 (each two 128-byte swizzled
// tiles of 64 columns) and x [TC_Q][TC_PS] bf16 (64-byte swizzle), as
// TMA writes them; two sets (chunk c in set c % 2) of x^T, then w x^T hi
// and lo, then two sets (the state after chunk c in set (c + 1) % 2) of
// h^T hi and lo, all [TC_PS][TC_Q] bf16, K-major (two 128-byte swizzled
// tiles of 64 columns); dt as loaded; two sets (chunk c in set c % 2) of
// [TC_Q] fp32 each of cum * log2(e), dt, w and the column factors, and
// exp(cum_end); 10 mbarriers
constexpr int TC_ST_B = TC_Q * TC_N * 2;
constexpr int TC_ST_X = 2 * TC_Q * TC_N * 2;
constexpr int TC_STAGE = TC_ST_X + TC_Q * TC_PS * 2;
constexpr int TC_T = TC_PS * TC_Q * 2;  // one transposed tile
constexpr int TC_OFF_XT = 2 * TC_STAGE;
constexpr int TC_OFF_WH = TC_OFF_XT + 2 * TC_T;
constexpr int TC_OFF_WL = TC_OFF_WH + TC_T;
constexpr int TC_OFF_H = TC_OFF_WL + TC_T;   // h^T hi, lo; two sets
constexpr int TC_OFF_DT = TC_OFF_H + 4 * TC_T;
constexpr int TC_OFF_SET = TC_OFF_DT + TC_Q * 4;
constexpr int TC_SET_BYTES = 4 * TC_Q * 4 + 16;
constexpr int TC_OFF_BAR = TC_OFF_SET + 2 * TC_SET_BYTES;
constexpr int TC_SMEM = TC_OFF_BAR + 80 + 1024;
// 228 KB a SM, of which the runtime keeps 1 KB a block
static_assert(TC_BLOCKS_PER_SM * (TC_SMEM + 1024) <= 228 * 1024,
              "shared memory of the blocks an SM is meant to hold");
constexpr float LOG2E = 1.4426950408889634f;

// byte offset of element k (0 .. 127) of row r in a K-major tile of R rows
// stored as two 128-byte swizzled tiles of 64 columns (chunk c of a row
// at c ^ (r & 7)), as TMA writes B and C and as wgmma reads them
__device__ __forceinline__ int swk(int r, int k, int R) {
    return (k >> 6) * R * 128 + r * 128 + ((((k >> 3) & 7) ^ (r & 7)) << 4) +
           (k & 7) * 2;
}
// byte offset of 16-byte chunk c of row r in x's 64-byte swizzled tile
__device__ __forceinline__ int sw64(int r, int c) {
    return r * 64 + ((c ^ ((r >> 1) & 3)) << 4);
}
// descriptor of K-step kk (16 columns) of a K-major tile of R rows
__device__ __forceinline__ uint64_t kdesc(const uint8_t* tile, int kk,
                                          int R) {
    return ptx::desc_sw128(tile + (kk >> 2) * R * 128 + (kk & 3) * 32, 16,
                           1024);
}

// 2^v by the SFU (ex2.approx.ftz: about 2 ulp, 0 below 2^-126), for the
// decays of y; w and exp(cum_end), which the state carries, use expf
__device__ __forceinline__ float ex2f(float v) {
    float r;
    asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
    return r;
}
// (a, b) = hi + lo to about 2^-17 relative: hi = bf16(v), lo = bf16(v -
// hi), two values a register, a in the lower half
__device__ __forceinline__ void split2(float a, float b, uint32_t& hi,
                                       uint32_t& lo) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
    const float2 hf = __bfloat1622float2(h);
    hi = *reinterpret_cast<const uint32_t*>(&h);
    lo = ptx::pack_bf16(a - hf.x, b - hf.y);
}

// The y warpgroups' work on chunk c, rows 64 wg .. 64 wg + 63; NS = 64
// (wg 0) or 128 (wg 1) score columns: C B^T, then C h once the state
// after chunk c - 1 is written, on the tensor cores; meanwhile the first
// warpgroup writes x^T; then, once the chunk's cumsum is written, M in
// registers, M x, and y to memory.
template <int NS>
__device__ __forceinline__ void y_chunk(
    const uint8_t* st, uint8_t* xt, const uint8_t* hin, const float* cum2,
    uint64_t* hrdy, uint64_t* cset, uint64_t* xtr, int tid, int c, int Q,
    int P, int H, int h, int p0, size_t row0, int vec,
    __nv_bfloat16* __restrict__ y) {
    const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
    const int wg = __shfl_sync(0xffffffffu, tid >> 7, 0), wq = warp & 3;
    const uint8_t* Cw = st + wg * 64 * 128;     // this warpgroup's rows of C
    const uint8_t* Bs = st + TC_ST_B;
    const float* dtv = cum2 + TC_Q;
    const float* ec = cum2 + 3 * TC_Q;
    float yacc[16], s[NS / 2];
#pragma unroll
    for (int e = 0; e < 16; ++e) yacc[e] = 0.f;
    ptx::wgmma_fence();             // C B^T, which needs no state
#pragma unroll
    for (int kn = 0; kn < 8; ++kn) {
        if constexpr (NS == 64)
            ptx::wgmma_ss_n64(s, kdesc(Cw, kn, TC_Q), kdesc(Bs, kn, TC_Q),
                              kn > 0);
        else
            ptx::wgmma_ss_n128(s, kdesc(Cw, kn, TC_Q), kdesc(Bs, kn, TC_Q),
                               kn > 0);
    }
    ptx::wgmma_commit();
    ptx::mbar_wait(hrdy, (c >> 1) & 1);       // the state after chunk c - 1
#pragma unroll                      // C h (h^T is 0 before the first chunk)
    for (int pass = 0; pass < 2; ++pass)
#pragma unroll
        for (int kn = 0; kn < 8; ++kn)
            ptx::wgmma_ss_n32(yacc, kdesc(Cw, kn, TC_Q),
                              kdesc(hin + pass * TC_T, kn, TC_PS), 1);
    ptx::wgmma_commit();

    if (NS == 64) {                 // x^T, K-major: rows j, j + 1 of 8 columns
        for (int idx = tid; idx < 256; idx += 128) {
            const int j = 2 * (idx >> 2), c4 = idx & 3;
            const uint4 xa = *reinterpret_cast<const uint4*>(
                st + TC_ST_X + sw64(j, c4));
            const uint4 xz = *reinterpret_cast<const uint4*>(
                st + TC_ST_X + sw64(j + 1, c4));
            const uint32_t ra[4] = {xa.x, xa.y, xa.z, xa.w};
            const uint32_t rz[4] = {xz.x, xz.y, xz.z, xz.w};
#pragma unroll
            for (int k = 0; k < 4; ++k)
#pragma unroll
                for (int u = 0; u < 2; ++u) {
                    const uint32_t b0 = u ? ra[k] >> 16 : ra[k] & 0xffffu;
                    const uint32_t b1 = u ? rz[k] >> 16 : rz[k] & 0xffffu;
                    *reinterpret_cast<uint32_t*>(
                        xt + swk(8 * c4 + 2 * k + u, j, TC_PS)) =
                        b0 | (b1 << 16);
                }
        }
        ptx::fence_proxy_async();
        ptx::mbar_arrive(xtr);
    }
    ptx::mbar_wait(cset, (c >> 1) & 1);       // the chunk's cumsum
    const int rt = 4 * wg + wq;               // row tile of this warp
    const int i0 = 16 * rt + g, i1 = i0 + 8;
    const float ci0 = cum2[i0], ci1 = cum2[i1];
    ptx::wgmma_wait<1>();                     // C B^T
    ptx::fence_regs(s);

    // the masked scores M = (C B^T) L dt, as bf16 hi and lo A fragments:
    // below the diagonal tile exp(cum_i - cum_j) = exp(cum_i - cum_e)
    // exp(cum_e - cum_j), both at most 1; on it exp only where j <= i;
    // above it 0
    uint32_t mh[NS / 16][4], ml[NS / 16][4];
#pragma unroll
    for (int kk = 0; kk < NS / 16; ++kk) {
        const int j0 = 16 * kk + 2 * t;
        float m[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) m[e] = s[8 * kk + e];
        if (kk < rt) {
            const float ce = cum2[16 * kk + 15];
            const float r0 = i0 < Q ? ex2f(ci0 - ce) : 0.f;
            const float r1 = i1 < Q ? ex2f(ci1 - ce) : 0.f;
            const float2 f0 = *reinterpret_cast<const float2*>(ec + j0);
            const float2 f1 = *reinterpret_cast<const float2*>(ec + j0 + 8);
            m[0] *= r0 * f0.x; m[1] *= r0 * f0.y;
            m[2] *= r1 * f0.x; m[3] *= r1 * f0.y;
            m[4] *= r0 * f1.x; m[5] *= r0 * f1.y;
            m[6] *= r1 * f1.x; m[7] *= r1 * f1.y;
        } else if (kk == rt) {
#pragma unroll
            for (int e = 0; e < 8; ++e) {
                const int j = j0 + (e & 1) + ((e >> 2) << 3);
                const int i = (e & 2) ? i1 : i0;
                const float ci = (e & 2) ? ci1 : ci0;
                m[e] = j <= i && i < Q ? m[e] * ex2f(ci - cum2[j]) * dtv[j]
                                       : 0.f;
            }
        } else {
#pragma unroll
            for (int e = 0; e < 8; ++e) m[e] = 0.f;
        }
        split2(m[0], m[1], mh[kk][0], ml[kk][0]);   // (g, 2t ..)
        split2(m[2], m[3], mh[kk][1], ml[kk][1]);   // (g + 8, 2t ..)
        split2(m[4], m[5], mh[kk][2], ml[kk][2]);   // (g, 2t + 8 ..)
        split2(m[6], m[7], mh[kk][3], ml[kk][3]);   // (g + 8, 2t + 8 ..)
    }

    ptx::wgmma_wait<0>();                     // C h
    ptx::fence_regs(yacc);
    const float e0 = ex2f(ci0), e1 = ex2f(ci1);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
        yacc[4 * q] *= e0;
        yacc[4 * q + 1] *= e0;
        yacc[4 * q + 2] *= e1;
        yacc[4 * q + 3] *= e1;
    }
    ptx::mbar_wait(xtr, (c >> 1) & 1);        // x^T
    ptx::wgmma_fence();                       // y += M x, two passes
#pragma unroll
    for (int kk = 0; kk < NS / 16; ++kk) {
        ptx::wgmma_rs_n32(yacc, mh[kk], kdesc(xt, kk, TC_PS), 1);
        ptx::wgmma_rs_n32(yacc, ml[kk], kdesc(xt, kk, TC_PS), 1);
    }
    ptx::wgmma_commit();
    ptx::wgmma_wait<0>();
    ptx::fence_regs(yacc);
    ptx::fence_regs(mh);
    ptx::fence_regs(ml);

#pragma unroll
    for (int hh2 = 0; hh2 < 2; ++hh2) {
        const int i = i0 + 8 * hh2;
        if (i >= Q) continue;
        __nv_bfloat16* yrow = y + ((row0 + i) * H + h) * (size_t)P;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
            const int p = p0 + 8 * q + 2 * t;
            const float v0 = yacc[4 * q + 2 * hh2];
            const float v1 = yacc[4 * q + 2 * hh2 + 1];
            if (vec && p + 1 < P) {
                *reinterpret_cast<__nv_bfloat162*>(yrow + p) =
                    __floats2bfloat162_rn(v0, v1);
            } else {
                if (p < P) yrow[p] = __float2bfloat16(v0);
                if (p + 1 < P) yrow[p + 1] = __float2bfloat16(v1);
            }
        }
    }
}

// x, y [B, S, H, P] bf16; dt [B, S, H] fp32; A [H] fp32; Bg, Cg [B, S, G,
// N] bf16; hlast [B, H, N, P] fp32. Grid (P slices of 32, H, B). vec: N
// and P multiples of 8 and x, Bg, Cg 16-byte aligned: B, C and x come by
// TMA through the tensor maps tm_b, tm_c, tm_x, else element by element.
__global__ void __launch_bounds__(TC_THREADS, TC_BLOCKS_PER_SM)
ssd_scan_wgmma_kernel(const __grid_constant__ CUtensorMap tm_b,
                    const __grid_constant__ CUtensorMap tm_c,
                    const __grid_constant__ CUtensorMap tm_x,
                    const __nv_bfloat16* __restrict__ x,
                    const float* __restrict__ dt, const float* __restrict__ A,
                    const __nv_bfloat16* __restrict__ Bg,
                    const __nv_bfloat16* __restrict__ Cg,
                    __nv_bfloat16* __restrict__ y, float* __restrict__ hlast,
                    int S, int H, int P, int G, int N, int Q, int vec) {
    extern __shared__ __align__(128) uint8_t sm_raw[];
    uint8_t* sm = sm_raw + ((1024 - (ptx::smem_addr(sm_raw) & 1023)) & 1023);
    uint8_t* wh = sm + TC_OFF_WH;
    uint8_t* wl = sm + TC_OFF_WL;
    float* dtb = reinterpret_cast<float*>(sm + TC_OFF_DT);
    // stage landed (1 arrival and TMA bytes), the chunk's cumsum set
    // written (warp 8: 32), the state written (128), x^T written (the
    // first y warpgroup: 128), the y warpgroups done with a chunk (256);
    // two of each, by chunk parity
    uint64_t* full = reinterpret_cast<uint64_t*>(sm + TC_OFF_BAR);
    uint64_t* cset = full + 2;
    uint64_t* hrdy = full + 4;
    uint64_t* xtr = full + 6;
    uint64_t* yfree = full + 8;

    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    // the warpgroup, warp-uniform to the compiler (a divergent wgmma path
    // would serialise the products)
    const int wg = __shfl_sync(0xffffffffu, tid >> 7, 0), wq = warp & 3;
    const int tid2 = tid - 256;       // thread of the state warpgroup
    const int p0 = blockIdx.x * TC_PS, h = blockIdx.y, b = blockIdx.z;
    const int grp = h / (H / G);
    const float a_h = A[h];
    const int nc = S / Q;
    const int nbc = (N + 63) >> 6;

    // chunk c into stage c % 2, by the state warpgroup: TMA boxes of Q
    // rows, 64 columns of B and C (a second box when N > 64), 32 of x; or
    // element by element and one arrival
    auto load = [&](int c) {
        uint8_t* st = sm + (c & 1) * TC_STAGE;
        uint64_t* fb = full + (c & 1);
        const size_t row0 = (size_t)b * S + (size_t)c * Q;
        if (vec) {
            if (tid2 == 0) {
                ptx::mbar_arrive_expect_tx(fb, (2 * nbc * 128 + 64) * Q);
                for (int cb = 0; cb < nbc; ++cb) {
                    ptx::tma_load_4d(st + cb * TC_Q * 128, &tm_c, fb, cb * 64,
                                     grp, c * Q, b);
                    ptx::tma_load_4d(st + TC_ST_B + cb * TC_Q * 128, &tm_b, fb,
                                     cb * 64, grp, c * Q, b);
                }
                ptx::tma_load_4d(st + TC_ST_X, &tm_x, fb, p0, h, c * Q, b);
            }
            return;
        }
        for (int idx = tid2; idx < TC_Q * TC_N; idx += 128) {
            const int r = idx >> 7, n = idx & 127;
            const size_t off = ((row0 + r) * G + grp) * (size_t)N + n;
            const bool ok = r < Q && n < N;
            const int o = swk(r, n, TC_Q);
            *reinterpret_cast<__nv_bfloat16*>(st + o) =
                ok ? Cg[off] : __float2bfloat16(0.f);
            *reinterpret_cast<__nv_bfloat16*>(st + TC_ST_B + o) =
                ok ? Bg[off] : __float2bfloat16(0.f);
        }
        for (int idx = tid2; idx < TC_Q * TC_PS; idx += 128) {
            const int r = idx >> 5, p = idx & 31;
            *reinterpret_cast<__nv_bfloat16*>(
                st + TC_ST_X + sw64(r, p >> 3) + (p & 7) * 2) =
                r < Q && p0 + p < P
                    ? x[((row0 + r) * H + h) * (size_t)P + p0 + p]
                    : __float2bfloat16(0.f);
        }
        ptx::fence_proxy_async();
        ptx::bar_sync_producers();
        if (tid2 == 0) ptx::mbar_arrive(fb);
    };
    // warp 8: dt of chunk c (load_dt, issued a chunk ahead), then (prep)
    // into set c % 2 the within-chunk cumsum of dt * A (lane l holds rows
    // 4l .. 4l + 3, dt is 0 past Q, then a warp scan of the lanes'
    // totals) in log2 units, dt, w, the column factors of the tiles below
    // the diagonal (dt_j exp(cum_e - cum_j), e the last column of j's
    // 16-column tile) and exp(cum_end); each lane arrives on cset
    auto load_dt = [&](int c) {
        const size_t row0 = (size_t)b * S + (size_t)c * Q;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
            const int j = lane * 4 + k;
            const bool ok = j < Q;
            ptx::cp_async_4(dtb + j, ok ? dt + (row0 + j) * H + h : dt,
                            ok ? 4 : 0);
        }
        ptx::cp_async_commit();
    };
    auto prep = [&](int c) {
        float* st = reinterpret_cast<float*>(sm + TC_OFF_SET
                                             + (c & 1) * TC_SET_BYTES);
        ptx::cp_async_wait<0>();
        float d[4], loc[4], run = 0.f;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
            d[k] = dtb[lane * 4 + k];   // this lane's own copies
            run += d[k] * a_h;
            loc[k] = run;
        }
        float incl = run;
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
            const float v = __shfl_up_sync(0xffffffffu, incl, off);
            if (lane >= off) incl += v;
        }
        const float excl = incl - run;
        const float cend = __shfl_sync(0xffffffffu, incl, 31);
        float c2[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
            const int j = lane * 4 + k;
            const float cj = excl + loc[k];
            c2[k] = cj * LOG2E;
            st[j] = c2[k];
            st[TC_Q + j] = d[k];
            st[2 * TC_Q + j] = j < Q ? expf(cend - cj) * d[k] : 0.f;
        }
        const float ce = __shfl_sync(0xffffffffu, c2[3], lane | 3);
#pragma unroll
        for (int k = 0; k < 4; ++k)
            st[3 * TC_Q + lane * 4 + k] = exp2f(ce - c2[k]) * d[k];
        if (lane == 0) st[4 * TC_Q] = expf(cend);
        ptx::mbar_arrive(cset + (c & 1));
    };

    if (tid == 0) {
        for (int i = 0; i < 2; ++i) {
            ptx::mbar_init(full + i, 1);
            ptx::mbar_init(cset + i, 32);
            ptx::mbar_init(hrdy + i, 128);
            ptx::mbar_init(xtr + i, 128);
            ptx::mbar_init(yfree + i, 256);
        }
        ptx::mbar_fence_init();
    }
    // the parts of the tiles that no box writes: rows Q .. 127, columns
    // past 64 when N <= 64
    if (vec) {
        for (int idx = tid; idx < 2 * TC_Q * 16; idx += TC_THREADS) {
            const int s2 = idx / (TC_Q * 16), r = (idx >> 4) & (TC_Q - 1);
            const int c16 = idx & 15;
            if (r < Q && c16 < 8 * nbc) continue;
            uint8_t* st = sm + s2 * TC_STAGE;
            const int o = swk(r, c16 * 8, TC_Q);
            *reinterpret_cast<uint4*>(st + o) = make_uint4(0, 0, 0, 0);
            *reinterpret_cast<uint4*>(st + TC_ST_B + o) =
                make_uint4(0, 0, 0, 0);
            if (r >= Q && c16 < 4)
                *reinterpret_cast<uint4*>(st + TC_ST_X + sw64(r, c16)) =
                    make_uint4(0, 0, 0, 0);
        }
    }
    // h^T before the first chunk: 0 (its hrdy phase is the state
    // warpgroup's first arrival)
    for (int idx = tid; idx < 2 * TC_T / 16; idx += TC_THREADS)
        reinterpret_cast<uint4*>(sm + TC_OFF_H)[idx] = make_uint4(0, 0, 0, 0);
    ptx::fence_proxy_async();
    __syncthreads();                  // the last block-wide barrier

    if (wg < 2) {
        // ---- the y warpgroups ------------------------------------------
        for (int c = 0; c < nc; ++c) {
            const size_t row0 = (size_t)b * S + (size_t)c * Q;
            const uint8_t* st = sm + (c & 1) * TC_STAGE;
            const float* cum2 = reinterpret_cast<const float*>(
                sm + TC_OFF_SET + (c & 1) * TC_SET_BYTES);
            uint8_t* xt = sm + TC_OFF_XT + (c & 1) * TC_T;
            const uint8_t* hin = sm + TC_OFF_H + (c & 1) * 2 * TC_T;
            const int q = c & 1;
            ptx::mbar_wait(full + q, (c >> 1) & 1);
            if (wg == 0)
                y_chunk<64>(st, xt, hin, cum2, hrdy + q, cset + q, xtr + q,
                            tid, c, Q, P, H, h, p0, row0, vec, y);
            else
                y_chunk<128>(st, xt, hin, cum2, hrdy + q, cset + q, xtr + q,
                             tid, c, Q, P, H, h, p0, row0, vec, y);
            ptx::mbar_arrive(yfree + (c & 1));
        }
        return;
    }

    // ---- the state warpgroup: loads, the cumsums, w x^T, the state
    // update h = exp(cum_end) h + B^T (w x) (two passes) on all 128 state
    // rows, and h^T for the next chunk's C h
    float ha[2][16];    // state rows 64 k + 16 wq + g (+ 8), cols 8q + 2t
#pragma unroll
    for (int k = 0; k < 2; ++k)
#pragma unroll
        for (int e = 0; e < 16; ++e) ha[k][e] = 0.f;
    load(0);
    if (nc > 1) load(1);
    if (warp == 8) {
        load_dt(0);
        prep(0);
    }
    ptx::mbar_arrive(hrdy);                   // h^T = 0 for chunk 0
    ptx::bar_sync_producers();
    for (int c = 0; c < nc; ++c) {
        if (c >= 1) {
            // chunk c - 1 is done: its stage, x^T and h^T sets are free
            ptx::mbar_wait(yfree + ((c - 1) & 1), ((c - 1) >> 1) & 1);
            if (c + 1 < nc) load(c + 1);
        }
        if (warp == 8 && c + 1 < nc) load_dt(c + 1);
        const uint8_t* st = sm + (c & 1) * TC_STAGE;
        const float* cum2 = reinterpret_cast<const float*>(
            sm + TC_OFF_SET + (c & 1) * TC_SET_BYTES);
        const float* wv = cum2 + 2 * TC_Q;
        uint8_t* hout = sm + TC_OFF_H + ((c + 1) & 1) * 2 * TC_T;
        ptx::mbar_wait(full + (c & 1), (c >> 1) & 1);

        // w x^T (hi, lo), K-major: rows j, j + 1 of 8 columns
        for (int idx = tid2; idx < 256; idx += 128) {
            const int j = 2 * (idx >> 2), c4 = idx & 3;
            const uint4 xa = *reinterpret_cast<const uint4*>(
                st + TC_ST_X + sw64(j, c4));
            const uint4 xz = *reinterpret_cast<const uint4*>(
                st + TC_ST_X + sw64(j + 1, c4));
            const uint32_t ra[4] = {xa.x, xa.y, xa.z, xa.w};
            const uint32_t rz[4] = {xz.x, xz.y, xz.z, xz.w};
            const float w0 = wv[j], w1 = wv[j + 1];
#pragma unroll
            for (int k = 0; k < 4; ++k) {
#pragma unroll
                for (int u = 0; u < 2; ++u) {
                    const int p = 8 * c4 + 2 * k + u;
                    const uint32_t b0 = u ? ra[k] >> 16 : ra[k] & 0xffffu;
                    const uint32_t b1 = u ? rz[k] >> 16 : rz[k] & 0xffffu;
                    const int o = swk(p, j, TC_PS);
                    const float x0 = __uint_as_float(b0 << 16);
                    const float x1 = __uint_as_float(b1 << 16);
                    uint32_t hi, lo;
                    split2(x0 * w0, x1 * w1, hi, lo);
                    *reinterpret_cast<uint32_t*>(wh + o) = hi;
                    *reinterpret_cast<uint32_t*>(wl + o) = lo;
                }
            }
        }
        ptx::fence_proxy_async();
        ptx::bar_sync_producers();            // w x^T written

        const float ae = cum2[4 * TC_Q];      // exp(cum_end)
#pragma unroll
        for (int k = 0; k < 2; ++k)
#pragma unroll
            for (int e = 0; e < 16; ++e) ha[k][e] *= ae;
        ptx::wgmma_fence();
#pragma unroll
        for (int jj = 0; jj < 8; ++jj)
#pragma unroll
            for (int k = 0; k < 2; ++k) {
                const uint64_t da = ptx::desc_sw128(
                    st + TC_ST_B + k * TC_Q * 128 + jj * 16 * 128, TC_Q * 128,
                    1024);
                ptx::wgmma_ss_n32_ta(ha[k], da, kdesc(wh, jj, TC_PS), 1);
                ptx::wgmma_ss_n32_ta(ha[k], da, kdesc(wl, jj, TC_PS), 1);
            }
        ptx::wgmma_commit();
        // warp 8 readies the next chunk under the products (set (c + 1) %
        // 2, free since chunk c - 1 is done)
        if (warp == 8 && c + 1 < nc) prep(c + 1);
        ptx::wgmma_wait<0>();
        ptx::fence_regs(ha[0]);
        ptx::fence_regs(ha[1]);

        // the state, as bf16 hi and lo, K-major h^T: rows p, columns n
#pragma unroll
        for (int k = 0; k < 2; ++k)
#pragma unroll
            for (int q = 0; q < 4; ++q)
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const int n = 64 * k + 16 * wq + g + 8 * (e >> 1);
                    const int p = 8 * q + 2 * t + (e & 1);
                    const float v = ha[k][4 * q + e];
                    const __nv_bfloat16 vh = __float2bfloat16(v);
                    const __nv_bfloat16 vl =
                        __float2bfloat16(v - __bfloat162float(vh));
                    const int o = swk(p, n, TC_PS);
                    *reinterpret_cast<__nv_bfloat16*>(hout + o) = vh;
                    *reinterpret_cast<__nv_bfloat16*>(hout + TC_T + o) = vl;
                }
        ptx::fence_proxy_async();
        ptx::mbar_arrive(hrdy + ((c + 1) & 1));
        ptx::bar_sync_producers();
    }
#pragma unroll
    for (int k = 0; k < 2; ++k)
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int n = 64 * k + 16 * wq + g + 8 * (e >> 1);
                const int p = p0 + 8 * q + 2 * t + (e & 1);
                if (n < N && p < P)
                    hlast[(((size_t)b * H + h) * N + n) * P + p] =
                        ha[k][4 * q + e];
            }
}

int launch_f32(const void* x, const void* dt, const void* A, const void* Bg,
               const void* Cg, void* y, void* hlast, int B, int S, int H,
               int P, int G, int N, int Q, cudaStream_t stream) {
    const Geom gm(Q, N, P);
    const size_t smem = gm.floats() * sizeof(float);
    if (smem > (size_t)SMEM_LIMIT) return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaFuncSetAttribute(
        ssd_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    dim3 grid((P + gm.PS - 1) / gm.PS, H, B);
    ssd_scan_kernel<<<grid, NTHREAD, smem, stream>>>(
        (const float*)x, (const float*)dt, (const float*)A, (const float*)Bg,
        (const float*)Cg, (float*)y, (float*)hlast, S, H, P, G, N, Q);
    return (int)cudaGetLastError();
}

int launch_bf16(const void* x, const void* dt, const void* A, const void* Bg,
                const void* Cg, void* y, void* hlast, int B, int S, int H,
                int P, int G, int N, int Q, cudaStream_t stream) {
    cudaError_t err = cudaFuncSetAttribute(
        ssd_scan_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        TC_SMEM);
    if (err != cudaSuccess) return (int)err;
    err = cudaFuncSetAttribute(ssd_scan_wgmma_kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               100);
    if (err != cudaSuccess) return (int)err;
    int vec = N % 8 == 0 && P % 8 == 0 &&
              ((uintptr_t)x | (uintptr_t)Bg | (uintptr_t)Cg) % 16 == 0;
    CUtensorMap tb{}, tc{}, tx{};
    if (vec)
        vec = ptx::tensor_map_4d(&tb, Bg, N, G, S, B, 64, Q,
                                 CU_TENSOR_MAP_SWIZZLE_128B) &&
              ptx::tensor_map_4d(&tc, Cg, N, G, S, B, 64, Q,
                                 CU_TENSOR_MAP_SWIZZLE_128B) &&
              ptx::tensor_map_4d(&tx, x, P, H, S, B, TC_PS, Q,
                                 CU_TENSOR_MAP_SWIZZLE_64B);
    dim3 grid((P + TC_PS - 1) / TC_PS, H, B);
    ssd_scan_wgmma_kernel<<<grid, TC_THREADS, TC_SMEM, stream>>>(
        tb, tc, tx, (const __nv_bfloat16*)x, (const float*)dt, (const float*)A,
        (const __nv_bfloat16*)Bg, (const __nv_bfloat16*)Cg,
        (__nv_bfloat16*)y, (float*)hlast, S, H, P, G, N, Q, vec);
    return (int)cudaGetLastError();
}

}  // namespace

// x, y [B, S, H, P], Bg, Cg [B, S, G, N], all fp32 (bf16 = 0: the CUDA
// cores) or all bf16 (bf16 = 1: the tensor cores); dt [B, S, H] fp32; A
// [H] fp32; hlast [B, H, N, P] fp32; all contiguous. 1 <= Q <= 128
// divides S, N <= 128, G divides H.
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
        return launch_bf16(x, dt, A, Bg, Cg, y, hlast, B, S, H, P, G, N, Q,
                           st);
    return launch_f32(x, dt, A, Bg, Cg, y, hlast, B, S, H, P, G, N, Q, st);
}
