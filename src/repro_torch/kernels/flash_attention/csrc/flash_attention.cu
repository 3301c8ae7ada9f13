// Flash attention forward for Hopper (sm_90a).
//
// Replaces the TPU Pallas kernel repro/kernels/flash_attention/kernel.py::
// flash_attention_fwd (kernel.py:84, pallas_call at :103): causal GQA/MQA
// attention with an optional sliding window and tanh logit softcap, online
// softmax with the running max, sum and accumulator in fp32, output in q's
// dtype. It is held to the plain version
// repro_torch/kernels/flash_attention/ref.py.
//
// What bounds it on the H100. At RecurrentGemma-9B's local layers (B = 1,
// S = 4096, H = 16 query heads over K = 1 KV head, Dh = 256, window 2048)
// the band holds about 1.0e8 (query, key) pairs per call, 4 * Dh = 1024
// FLOP each: 1.03e11 FLOP, 104 us at the 989 TFLOP/s bf16 tensor-core
// rate, while the bytes (q, k, v, o: 35 MB) take 10 us. Operations bound
// it, so both products run on the tensor cores, through wgmma.
//
// bf16 (every timed path): flash_fwd_wgmma_kernel.
//   * A block owns 128 query rows: 128 / hpb positions of hpb query heads
//     of one KV group (hpb = heads per block: 2 when H / K is even, else
//     1), so each K/V tile feeds 128 rows; query head h reads KV head
//     h / (H / K), the reference's [B, S, K, G, Dh] grouping. Two heads of
//     64 positions beat one of 128 by 4% at RecurrentGemma's shape (fewer
//     masked pairs on the diagonal); four and eight were no faster.
//   * Two consumer warpgroups own 64 rows each and the whole padded head
//     width DP of their fp32 accumulator (DP / 2 registers a thread: 128 at
//     Dh = 256). S = Q K^T for a 64-key tile is wgmma m64n64k16 with Q and
//     K in shared memory; it is scaled, masked and exponentiated in
//     registers, rounded to bf16 (as FlashAttention-2/3 do) and fed back as
//     the register A operand of O += P V (wgmma m64nDPk16, V in shared
//     memory, MN-major). Row max and sum are two shuffles over the 4 lanes
//     of a row.
//   * The products of tile j + 1's scores and of tile j's P V are issued
//     together, and tile j + 1's softmax runs while P V does; the last tile
//     is peeled off so that ptxas sees the two commits before each wait.
//   * A producer warpgroup keeps the tensor cores fed: one thread issues
//     TMA loads (4-d tensor maps over [B, S, heads, Dh], boxes of 64
//     columns, 128-byte swizzle, zeros outside S and Dh) into a ring of 2 K
//     and 2 V slots, each with a "full" mbarrier (transaction bytes) and an
//     "empty" one that the consumers arrive on as soon as the product that
//     read the slot is done. There is no block-wide barrier in the loop,
//     so the warpgroups drift apart and overlap each other's softmax.
//     setmaxnreg moves registers from the producer (40) to the consumers
//     (232). Q (64 KB at Dh = 256) and the ring (4 x 32 KB) take 193 KB.
//   * The KV loop visits only the tiles that meet [q0 - W + 1, q_last] (the
//     Pallas kernel visits all of them and masks the rest to -1e30, which
//     adds exactly zero); only the tiles on the diagonal, on the window's
//     lower edge or past S run the element mask.
//   * Scores go to log2 units with log2(e) / sqrt(Dh) folded into one
//     multiply (after the tanh when there is a softcap) and ex2.approx; a
//     row that has seen only masked keys keeps m = -inf and takes 0 in its
//     place, so masked keys add exactly zero, as in the plain version.
//   * Blocks are ordered so that the q-tiles with the longest key range
//     start first; the output goes through shared memory to 16-byte stores.
//   * Dh from 1 to 256 pads to DP = 64, 128 or 256 with zero columns that
//     are never stored. When Dh % 8 != 0 (a row that is no multiple of 16
//     bytes, which TMA cannot address) or a pointer is not 16-byte aligned,
//     the producer warpgroup copies element by element into the same
//     swizzled layout instead.
// What still separates it from the bound (PERF.md has the times): S reads
// Q and K from shared memory, 64 KB a warpgroup for 2.1 MFLOP a tile, so
// the S product runs at the shared-memory rate, not the tensor-core rate;
// the two warpgroups' softmax is not scheduled against each other's
// products (FlashAttention-3's ping-pong); and the masked halves of the
// diagonal tiles are computed.
//
// fp32: flash_fwd_kernel, the first CUDA-core kernel, unchanged. The fp32
// checks (chip_smoke.py, 1e-4 against the plain version) need full fp32
// products, which TF32 tensor cores (about three decimal digits) would
// miss; no timed path runs attention in fp32. One block of 8 warps per
// (batch, query head, 64-row tile), Q and one 32-key K/V tile in shared
// memory as fp32, lane c scores key c, the probabilities go through
// shared memory to P V.
//
// Plain C interface, loaded with ctypes. The entry point launches on the
// caller's stream, does not synchronise, and returns cudaGetLastError().

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "ptx.cuh"

namespace {

constexpr int BQ = 64;              // query rows per block
constexpr int BK = 32;              // keys per tile: one per lane
constexpr int NWARP = 8;
constexpr int NTHREAD = NWARP * 32;
constexpr int ROWS = BQ / NWARP;    // query rows per warp
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f(float x) { return x; }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
    return x;
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

// ---------------------------------------------------------------------------
// bf16: tensor cores (wgmma, fp32 accumulation)
// ---------------------------------------------------------------------------
using bf16 = __nv_bfloat16;

constexpr int MMA_M = 128;             // query rows a block, over hpb heads
constexpr int MMA_BK = 64;             // keys a K/V tile
constexpr int MMA_WARPS = MMA_M / 16;  // consumer warps, 16 rows each
constexpr int MMA_THREADS = MMA_WARPS * 32;
constexpr float LOG2E = 1.4426950408889634f;

// element offset of (row r, column col) in a tile of R rows stored as
// 64-column blocks of R rows x 128 bytes, 16-byte chunks swizzled by r % 8
__device__ __forceinline__ int sw128(int r, int col, int R) {
    return (col >> 6) * R * 64 + r * 64 +
           ((((col >> 3) & 7) ^ (r & 7)) << 3) + (col & 7);
}

template <int DP>
__device__ __forceinline__ void wgmma_pv(float (&o)[DP / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
    if constexpr (DP == 64) ptx::wgmma_rs_n64(o, a, db, 1);
    else if constexpr (DP == 128) ptx::wgmma_rs_n128(o, a, db, 1);
    else ptx::wgmma_rs_n256(o, a, db, 1);
}

__device__ __forceinline__ float ex2(float x) {  // 2^x; ex2(-inf) = 0
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
    return y;
}

// One tile's scores (fp32, the thread's rows g and g + 8 of its warp) to
// probabilities in place: scale to log2 units (softcap first), the element
// mask on an edge tile, then the online-softmax update of the running max
// m and this lane's share of the running sum l; alpha gets the factor
// that rescales the rows' accumulator.
template <int NT>
__device__ __forceinline__ void tile_softmax(
    float (&s)[NT * 4], float (&m)[2], float (&l)[2], float (&alpha)[2],
    int k0, int qrow, int t4, bool edge, int S, int causal, int window,
    float softcap, float inv_sqrt_dh) {
    if (softcap != 0.f) {
#pragma unroll
        for (int j = 0; j < NT * 4; ++j)
            s[j] = tanhf(s[j] * inv_sqrt_dh / softcap) * (softcap * LOG2E);
    } else {
#pragma unroll
        for (int j = 0; j < NT * 4; ++j) s[j] *= inv_sqrt_dh * LOG2E;
    }
    if (edge) {
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int c = 0; c < 4; ++c) {
                const int qi = qrow + (c >> 1) * 8;
                const int kj = k0 + j * 8 + 2 * t4 + (c & 1);
                bool ok = kj < S;
                if (causal) ok = ok && kj <= qi;
                if (window) ok = ok && kj > qi - window;
                if (!ok) s[j * 4 + c] = -INFINITY;
            }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < NT; ++j)
            mx = fmaxf(mx, fmaxf(s[j * 4 + 2 * i], s[j * 4 + 2 * i + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 2));
        const float m_new = fmaxf(m[i], mx);
        // a row that has seen only masked keys keeps m = -inf and
        // subtracts 0: 2^-inf = 0, so masked keys add nothing
        const float m_use = m_new == -INFINITY ? 0.f : m_new;
        alpha[i] = ex2(m[i] - m_use);
        m[i] = m_new;
        float ps = 0.f;
#pragma unroll
        for (int j = 0; j < NT; ++j) {
            s[j * 4 + 2 * i] = ex2(s[j * 4 + 2 * i] - m_use);
            s[j * 4 + 2 * i + 1] = ex2(s[j * 4 + 2 * i + 1] - m_use);
            ps += s[j * 4 + 2 * i] + s[j * 4 + 2 * i + 1];
        }
        l[i] = l[i] * alpha[i] + ps;  // the row's 4 lanes summed at the end
    }
}

// element copy of nrows rows into a swizzled tile by the producer
// warpgroup (the path for rows that TMA cannot address: Dh % 8 != 0 or
// unaligned pointers)
template <int DP, typename Off>
__device__ __forceinline__ void copy_rows_sw(bf16* dst, const bf16* src,
                                             int nrows, int Dh, int ptid,
                                             Off off) {
    for (int i = ptid; i < nrows * DP; i += 128) {
        const int r = i / DP, c = i % DP;
        const long long gi = off(r);
        dst[sw128(r, c, nrows)] =
            (gi >= 0 && c < Dh) ? src[gi + c] : __float2bfloat16(0.f);
    }
}

constexpr int PRODUCER_REGS = 40;   // registers a producer thread keeps
constexpr int CONSUMER_REGS = 232;  // and a consumer thread takes

// DP = padded head width: 64, 128 or 256. Warps 0-7 (two warpgroups of 64
// rows) compute; warpgroup 2 produces: TMA loads (or element copies) into
// a ring of 2 K and 2 V slots, each with a "full" and an "empty" mbarrier,
// and gives most of its registers to the consumers (setmaxnreg: 168 a
// thread at launch, 40 + 2 x 232 = 3 x 168 after).
template <int DP>
__global__ void __launch_bounds__(MMA_THREADS + 128, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tmap_q,
                       const __grid_constant__ CUtensorMap tmap_k,
                       const __grid_constant__ CUtensorMap tmap_v,
                       const bf16* __restrict__ q,
                       const bf16* __restrict__ k,
                       const bf16* __restrict__ v, bf16* __restrict__ o,
                       int B, int S, int H, int KH, int Dh, int causal,
                       int window, float softcap, float inv_sqrt_dh, int hpb,
                       int tma) {
    constexpr int NT = MMA_BK / 8;     // 8-key column tiles of S
    constexpr int TILE = MMA_BK * DP;  // elements of one K or V tile
    extern __shared__ __align__(1024) unsigned char smem_raw[];
    // swizzle atoms need 1024-byte alignment
    bf16* sQ = reinterpret_cast<bf16*>(
        smem_raw + ((1024 - (ptx::smem_addr(smem_raw) & 1023)) & 1023));
    bf16* sK = sQ + MMA_M * DP;        // 2 slots: tile t_lo + j in slot j & 1
    bf16* sV = sK + 2 * TILE;          // 2 slots
    uint64_t* bars = reinterpret_cast<uint64_t*>(sV + 2 * TILE);
    uint64_t* full_q = bars;           // 1
    uint64_t* full_k = bars + 1;       // 2
    uint64_t* full_v = bars + 3;       // 2
    uint64_t* empty_k = bars + 5;      // 2
    uint64_t* empty_v = bars + 7;      // 2

    const int bq = MMA_M / hpb;        // query positions a block
    const int n_hg = H / hpb;
    const int per_qt = n_hg * B;
    const int n_qt = (S + bq - 1) / bq;
    // the q-tiles with the longest key range first
    const int qt = n_qt - 1 - (int)(blockIdx.x / per_qt);
    const int rest = (int)(blockIdx.x % per_qt);
    const int h0 = (rest % n_hg) * hpb;
    const int b = rest / n_hg;
    const int kh = h0 / (H / KH);
    const int q0 = qt * bq;
    const int q_last = min(q0 + bq, S) - 1;
    // KV tiles that meet the band of rows q0 .. q_last
    const int kv_lo = window ? max(0, q0 - window + 1) : 0;
    const int kv_hi = causal ? q_last + 1 : S;  // exclusive
    const int t_lo = kv_lo / MMA_BK;
    const int n = (kv_hi + MMA_BK - 1) / MMA_BK - t_lo;  // tiles to visit

    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    if (tid == 0) {
        ptx::mbar_init(full_q, 1);
        for (int i = 0; i < 2; ++i) {
            ptx::mbar_init(full_k + i, 1);
            ptx::mbar_init(full_v + i, 1);
            ptx::mbar_init(empty_k + i, MMA_THREADS);
            ptx::mbar_init(empty_v + i, MMA_THREADS);
        }
        ptx::mbar_fence_init();
    }
    __syncthreads();                   // the last block-wide barrier

    if (warp >= MMA_WARPS) {
        // producer: Q, then K(j) and V(j) into slot j & 1 once the
        // consumers have released tile j - 2 there
        ptx::setmaxnreg_dec<PRODUCER_REGS>();
        const int ptid = tid - MMA_THREADS;
        auto kv_off = [&](int t) {
            return [=](int r) -> long long {
                const int kj = t * MMA_BK + r;
                return kj < S ? (((long long)b * S + kj) * KH + kh) * Dh : -1;
            };
        };
        if (tma) {
            if (ptid == 0) {
                ptx::mbar_arrive_expect_tx(full_q, MMA_M * DP * 2);
                for (int hh = 0; hh < hpb; ++hh)
                    for (int cb = 0; cb < DP / 64; ++cb)
                        ptx::tma_load_4d(sQ + cb * MMA_M * 64 + hh * bq * 64,
                                         &tmap_q, full_q, cb * 64, h0 + hh,
                                         q0, b);
                for (int j = 0; j < n; ++j) {
                    const int slot = j & 1, t = t_lo + j;
                    if (j >= 2)
                        ptx::mbar_wait(empty_k + slot, ((j >> 1) - 1) & 1);
                    ptx::mbar_arrive_expect_tx(full_k + slot, TILE * 2);
                    for (int cb = 0; cb < DP / 64; ++cb)
                        ptx::tma_load_4d(sK + slot * TILE + cb * MMA_BK * 64,
                                         &tmap_k, full_k + slot, cb * 64, kh,
                                         t * MMA_BK, b);
                    if (j >= 2)
                        ptx::mbar_wait(empty_v + slot, ((j >> 1) - 1) & 1);
                    ptx::mbar_arrive_expect_tx(full_v + slot, TILE * 2);
                    for (int cb = 0; cb < DP / 64; ++cb)
                        ptx::tma_load_4d(sV + slot * TILE + cb * MMA_BK * 64,
                                         &tmap_v, full_v + slot, cb * 64, kh,
                                         t * MMA_BK, b);
                }
            }
        } else {
            // all 128 threads copy; each makes its stores visible to the
            // tensor cores, the warpgroup meets, one thread arrives
            auto publish = [&](uint64_t* bar) {
                ptx::fence_proxy_async();
                ptx::bar_sync_producers();
                if (ptid == 0) ptx::mbar_arrive(bar);
            };
            copy_rows_sw<DP>(sQ, q, MMA_M, Dh, ptid, [&](int r) -> long long {
                const int qi = q0 + r % bq;  // row r: head h0 + r / bq
                return qi < S ? (((long long)b * S + qi) * H + h0 + r / bq) *
                                    Dh
                              : -1;
            });
            publish(full_q);
            for (int j = 0; j < n; ++j) {
                const int slot = j & 1, t = t_lo + j;
                if (j >= 2) ptx::mbar_wait(empty_k + slot, ((j >> 1) - 1) & 1);
                copy_rows_sw<DP>(sK + slot * TILE, k, MMA_BK, Dh, ptid,
                                 kv_off(t));
                publish(full_k + slot);
                if (j >= 2) ptx::mbar_wait(empty_v + slot, ((j >> 1) - 1) & 1);
                copy_rows_sw<DP>(sV + slot * TILE, v, MMA_BK, Dh, ptid,
                                 kv_off(t));
                publish(full_v + slot);
            }
        }
        return;
    }
    ptx::setmaxnreg_inc<CONSUMER_REGS>();

    // consumers
    const int g = lane >> 2, t4 = lane & 3;
    const int wph = MMA_WARPS / hpb;   // warps a head
    const int hw = h0 + warp / wph;    // this warp's query head
    const int qw = q0 + (warp % wph) * 16;  // its first query position
    const int rw = warp * 16;          // its first row of sQ
    const bf16* sQw = sQ + (warp >> 2) * 64 * 64;  // its warpgroup's rows
    auto edge = [&](int t) {  // tile t crosses an edge of the band
        const int k0 = t * MMA_BK;
        return (causal && k0 + MMA_BK - 1 > q0) ||
               (window && k0 <= q_last - window) || k0 + MMA_BK > S;
    };

    float s[NT * 4];                   // scores, then probabilities
    uint32_t pa[MMA_BK / 16][4];       // P in bf16, A operand of P V
    float acc[DP / 2];
#pragma unroll
    for (int j = 0; j < DP / 2; ++j) acc[j] = 0.f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, alpha[2];

    // S = Q K^T of tile j, issued: 16 columns of the head a step, K-major
    auto issue_scores = [&](int j) {
        const bf16* cK = sK + (j & 1) * TILE;
        ptx::mbar_wait(full_k + (j & 1), (j >> 1) & 1);
        ptx::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < DP / 16; ++kk) {
            const int col = (kk & 3) * 16;  // 32 bytes a step in the atom
            ptx::wgmma_ss_n64(
                s,
                ptx::desc_sw128(sQw + (kk >> 2) * MMA_M * 64 + col, 16, 1024),
                ptx::desc_sw128(cK + (kk >> 2) * MMA_BK * 64 + col, 16, 1024),
                kk > 0);
        }
        ptx::wgmma_commit();
    };
    // O += P V of tile j, issued: P from registers, V MN-major
    auto issue_pv = [&](int j) {
        const bf16* cV = sV + (j & 1) * TILE;
        ptx::mbar_wait(full_v + (j & 1), (j >> 1) & 1);
        ptx::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < MMA_BK / 16; ++kk)
            wgmma_pv<DP>(acc, pa[kk],
                         ptx::desc_sw128(cV + kk * 16 * 64, MMA_BK * 128,
                                         1024));
        ptx::wgmma_commit();
    };
    auto pack_p = [&]() {  // P rounded to bf16, as the A fragment
#pragma unroll
        for (int kk = 0; kk < MMA_BK / 16; ++kk) {
            pa[kk][0] = ptx::pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
            pa[kk][1] = ptx::pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
            pa[kk][2] = ptx::pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
            pa[kk][3] = ptx::pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
        }
    };

    ptx::mbar_wait(full_q, 0);
    if (n > 0) {
        issue_scores(0);
        ptx::wgmma_wait<0>();
        ptx::fence_regs(s);
        ptx::mbar_arrive(empty_k);
        tile_softmax<NT>(s, m, l, alpha, t_lo * MMA_BK, qw + g, t4,
                         edge(t_lo), S, causal, window, softcap,
                         inv_sqrt_dh);
        pack_p();
    }
    // Step j: S(j + 1) and P(j) V(j) go to the tensor cores together, and
    // the softmax of j + 1 runs while P(j) V(j) does; each slot is released
    // to the producer as soon as its product is done. The last tile is
    // peeled off, so that every wgmma_wait<1> follows two commits (ptxas
    // serialises the products when it cannot tell).
    for (int j = 0; j + 1 < n; ++j) {
        issue_scores(j + 1);
        issue_pv(j);
        ptx::wgmma_wait<1>();          // S(j + 1) is done, P(j) V(j) may not be
        ptx::fence_regs(s);
        ptx::mbar_arrive(empty_k + ((j + 1) & 1));
        tile_softmax<NT>(s, m, l, alpha, (t_lo + j + 1) * MMA_BK, qw + g, t4,
                         edge(t_lo + j + 1), S, causal, window, softcap,
                         inv_sqrt_dh);
        ptx::wgmma_wait<0>();
        ptx::fence_regs(acc);
        ptx::fence_regs(pa);
        ptx::mbar_arrive(empty_v + (j & 1));
#pragma unroll
        for (int i = 0; i < DP / 8; ++i) {
            acc[i * 4 + 0] *= alpha[0];
            acc[i * 4 + 1] *= alpha[0];
            acc[i * 4 + 2] *= alpha[1];
            acc[i * 4 + 3] *= alpha[1];
        }
        pack_p();
    }
    if (n > 0) {
        issue_pv(n - 1);
        ptx::wgmma_wait<0>();
        ptx::fence_regs(acc);
    }

    float inv[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        l[i] += __shfl_xor_sync(FULL, l[i], 1);
        l[i] += __shfl_xor_sync(FULL, l[i], 2);
        inv[i] = l[i] > 0.f ? 1.f / l[i] : 0.f;  // an all-masked row is 0
    }
    // the warp's 16 output rows through its own rows of sQ (same swizzle;
    // its warpgroup's products have read them)
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
        const int c = j * 8 + 2 * t4;
        *reinterpret_cast<uint32_t*>(sQ + sw128(rw + g, c, MMA_M)) =
            ptx::pack_bf16(acc[j * 4] * inv[0], acc[j * 4 + 1] * inv[0]);
        *reinterpret_cast<uint32_t*>(sQ + sw128(rw + g + 8, c, MMA_M)) =
            ptx::pack_bf16(acc[j * 4 + 2] * inv[1], acc[j * 4 + 3] * inv[1]);
    }
    __syncwarp();
    const long long orow = ((long long)b * S + qw) * H + hw;  // row qw
    if (tma) {                         // rows of 16-byte multiples, aligned
        constexpr int CPR = DP / 8;
        for (int i = lane; i < 16 * CPR; i += 32) {
            const int r = i / CPR, c = (i % CPR) * 8;
            if (qw + r < S && c < Dh)
                *reinterpret_cast<uint4*>(o + (orow + (long long)r * H) * Dh +
                                          c) =
                    *reinterpret_cast<const uint4*>(sQ +
                                                    sw128(rw + r, c, MMA_M));
        }
    } else {
        for (int i = lane; i < 16 * DP; i += 32) {
            const int r = i / DP, c = i % DP;
            if (qw + r < S && c < Dh)
                o[(orow + (long long)r * H) * Dh + c] =
                    sQ[sw128(rw + r, c, MMA_M)];
        }
    }
}

// x [B, S, heads, Dh] bf16 as a 4-d tensor map, boxes of 64 columns x `rows`
// positions of one head, 128-byte swizzle, zeros outside
bool tensor_map(CUtensorMap* map, const void* x, int B, int S, int heads,
                int Dh, int rows) {
    return ptx::tensor_map_4d(map, x, Dh, heads, S, B, 64, rows,
                              CU_TENSOR_MAP_SWIZZLE_128B);
}

template <int DP>
int launch_wgmma(const void* q, const void* k, const void* v, void* o, int B,
                 int S, int H, int KH, int Dh, int causal, int window,
                 float softcap, float sqrt_dh, int hpb, int tma,
                 cudaStream_t stream) {
    const size_t smem = sizeof(bf16) * (size_t)(MMA_M + 4 * MMA_BK) * DP +
                        9 * sizeof(uint64_t) + 1024;
    auto kern = flash_fwd_wgmma_kernel<DP>;
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const int bq = MMA_M / hpb;
    CUtensorMap tq{}, tk{}, tv{};
    if (tma && !(tensor_map(&tq, q, B, S, H, Dh, bq) &&
                 tensor_map(&tk, k, B, S, KH, Dh, MMA_BK) &&
                 tensor_map(&tv, v, B, S, KH, Dh, MMA_BK)))
        return (int)cudaErrorInvalidValue;
    const long long blocks = (long long)((S + bq - 1) / bq) * (H / hpb) * B;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    kern<<<(unsigned)blocks, MMA_THREADS + 128, smem, stream>>>(
        tq, tk, tv, (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o,
        B, S, H, KH, Dh, causal, window, softcap, 1.f / sqrt_dh, hpb, tma);
    return (int)cudaGetLastError();
}

int launch_bf16(const void* q, const void* k, const void* v, void* o, int B,
                int S, int H, int KH, int Dh, int causal, int window,
                float softcap, float sqrt_dh, cudaStream_t stream) {
    const int hpb = (H / KH) % 2 == 0 ? 2 : 1;  // heads per block
    const uintptr_t ptrs = (uintptr_t)q | (uintptr_t)k | (uintptr_t)v |
                           (uintptr_t)o;
    // TMA needs 16-byte aligned rows; else the producer copies elements
    const int tma = Dh % 8 == 0 && (ptrs & 15) == 0;
    if (Dh <= 64)
        return launch_wgmma<64>(q, k, v, o, B, S, H, KH, Dh, causal, window,
                                softcap, sqrt_dh, hpb, tma, stream);
    if (Dh <= 128)
        return launch_wgmma<128>(q, k, v, o, B, S, H, KH, Dh, causal, window,
                                 softcap, sqrt_dh, hpb, tma, stream);
    return launch_wgmma<256>(q, k, v, o, B, S, H, KH, Dh, causal, window,
                             softcap, sqrt_dh, hpb, tma, stream);
}

}  // namespace

// q [B, S, H, Dh], k/v [B, S, KH, Dh] -> o [B, S, H, Dh], all contiguous,
// fp32 (is_bf16 = 0: the CUDA-core kernel) or bf16 (is_bf16 = 1: the
// tensor-core kernel). 1 <= Dh <= 256, H % KH == 0.
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
        return launch_bf16(q, k, v, o, B, S, H, KH, Dh, causal, window,
                           softcap, sqrt_dh, st);
    return launch_dh<float>(q, k, v, o, B, S, H, KH, Dh, causal, window,
                            softcap, sqrt_dh, st);
}
