// Weight-absorbed MLA decode attention over the latent cache, for Hopper
// (sm_90a).
//
// Replaces no TPU kernel: the JAX package leaves this attention to XLA
// (`repro/models/mla.py::_mla_attend_absorbed`). It was added because the
// port's plain chain of tensor operations for it took half of a
// DeepSeek-V2-Lite decode step on the H100: at every step and in every
// layer it normalised the whole latent cache in fp32, cast it twice,
// multiplied in fp32 and read every row, the rows past the valid length
// too.
//
// For one query position per batch row it computes what the plain
// version `repro_torch/kernels/mla_decode/ref.py` computes, in the same
// precisions:
//   ckn   = bf16(rms_norm(c_kv) * kv_norm)        (fp32 inside)
//   s     = (q_lat . ckn + q_rope . k_rope) * scale  (bf16 in, fp32 sums)
//   s     = -inf at every position j >= min(kv_valid, q_pos + 1)
//   o_lat = bf16(softmax(s) (bf16) . ckn)           (fp32 sums)
// with the softmax online (flash style): the unnormalised weights go to
// bf16 and the sum is divided at the end, where the plain version divides
// first; either rounds each weight to bf16 once.
//
// What bounds it on the H100: bytes. A row's cache holds R + Dr bf16
// values a position (1,152 B at DeepSeek-V2-Lite's R 512, Dr 64), and
// each is used by every head: 2 (R + Dr) + 2 R operations a head and a
// position, so 16 heads do about 30 operations a byte, far under the
// card's 295 a byte in bf16. At the LM cell's batch 64 and cache 1,324 a
// call reads 97.6 MB: 29 us at 3.35 TB/s.
//
// Design: each cache byte is read once. The grid is (splits, batch rows,
// head groups), a row's splits one thread block cluster; block (c, b)
// takes split c of row b's valid positions, whose count it reads on the
// device, so a CUDA graph captured once serves every step (a split with
// no position takes part with an empty sum). The block's positions come
// in tiles of 32, and its two groups of 8 warps take alternate tiles,
// each through its own ring of two cp.async stages in shared memory (all
// that fits); the second group starts a phase behind the first, so that
// one group's loads and norms overlap the other's products. A group, for
// each of its tiles:
//   1. normalises the tile's rows in place, 4 rows a warp at once (fp32
//      sum of squares by warp shuffles, rsqrt, times kv_norm, rounded to
//      bf16), so both products read the same bf16 values as the plain
//      version;
//   2. multiplies (mma.sync m16n8k16, bf16 in, fp32 out; heads on M,
//      padded to 16) each warp's share of the latent's 16-wide k blocks
//      into partial scores in shared memory, and the rope a (head tile,
//      8 positions) pair a warp;
//   3. a warp a head: sums the partials in a fixed order, scales, masks,
//      updates the head's running max, and writes the weights as bf16;
//      each lane keeps its own part of the running sum until the end;
//   4. rescales and adds the weighted tile into each warp's columns of
//      the [heads, R] fp32 accumulator, kept in registers.
// At the end the second group's (O, max, sum) goes through shared memory
// to the first, which merges the two into the block's; then each block of
// the cluster reads a slice of the columns from every block's shared
// memory, in split order, and writes that slice of o_lat. No atomics and
// no global scratch: the result does not depend on the order blocks run,
// so a replayed graph gives the eager call's bits.
//
// Plain C interface, loaded with ctypes. The entry point launches on the
// caller's stream, does not synchronise, and returns cudaGetLastError().

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "ptx.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int W = 8;             // warps a group
constexpr int G = 2;             // groups a block, on alternate tiles
constexpr int GTHREAD = 32 * W;
constexpr int NTHREAD = G * GTHREAD;
constexpr int T = 32;            // positions a tile: a lane each
constexpr int STAGES = 2;        // tiles in a group's ring
constexpr int RPW = T / W;       // rows a warp normalises a tile
constexpr int PAD = 8;           // bf16 padding a shared row (no conflicts)
constexpr int MAX_SPLITS = 8;    // splits of a row: a cluster

// shapes of one instantiation: latent width R, rope width DR, MT tiles of
// 16 heads a block
template <int R, int DR, int MT>
struct Shape {
    static constexpr int HB = 16 * MT;               // heads a block, padded
    static constexpr int DRP = (DR + 15) / 16 * 16;  // rope width, padded
    static constexpr int KB = R / 16;                // latent k blocks
    static constexpr int KBW = (KB + W - 1) / W;     // ... a warp
    static constexpr int NRED = (KB + KBW - 1) / KBW;  // warps with some
    static constexpr int NT = R / 8;                 // output n tiles
    static constexpr int NTW = (NT + W - 1) / W;     // ... a warp
    static constexpr int RB = DRP / 16;              // rope k blocks
    static constexpr int RS = R + PAD, DS = DRP + PAD, PS = T + PAD;
    static constexpr int FS = T + 8;                 // fp32 row stride
    static constexpr int CH = R / 8, CHD = DR / 8;   // 16-byte chunks a row
    static constexpr int CPL = (CH + 31) / 32;       // ... a lane
    static constexpr int HPW = HB / W;               // softmax heads a warp
    // shared memory in bytes: the queries, then each group's ring, weights,
    // partial scores, rope scores and per-head values, in this order
    static constexpr size_t QS = (size_t)HB * RS * 2;
    static constexpr size_t QR = (size_t)HB * DS * 2;
    static constexpr size_t KV = (size_t)STAGES * T * RS * 2;
    static constexpr size_t KR = (size_t)STAGES * T * DS * 2;
    static constexpr size_t PB = (size_t)HB * PS * 2;
    static constexpr size_t RED = (size_t)NRED * HB * FS * 4;
    static constexpr size_t RSC = (size_t)HB * FS * 4;
    static constexpr size_t VEC = (size_t)3 * HB * 4;
    static constexpr size_t GROUP = KV + KR + PB + RED + RSC + VEC;
    // the block's merged max and sum a head, and each split's weight and
    // the inverse sum for the heads of the final merge
    static constexpr size_t XV = (size_t)HB * (3 + MAX_SPLITS) * 4;
    static constexpr size_t SMEM = QS + QR + G * GROUP + XV;
    static_assert((size_t)HB * R * 4 <= GROUP - VEC,
                  "the second group's accumulator fits its own space");
    static_assert(R % 16 == 0 && DR % 8 == 0, "R % 16, Dr % 8");
    static_assert(HB % W == 0, "heads a block over the warps");
};

__device__ __forceinline__ void cp_async_16(void* dst, const void* src,
                                            int bytes) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     ptx::smem_addr(dst)),
                 "l"(src), "r"(bytes)
                 : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(ptx::smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const void* p) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
                 : "=r"(r[0]), "=r"(r[1])
                 : "r"(ptx::smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
        "[%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(ptx::smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x2_t(uint32_t (&r)[2], const void* p) {
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
        : "=r"(r[0]), "=r"(r[1])
        : "r"(ptx::smem_addr(p)));
}

// d += a b, m16n8k16, bf16 in, fp32 sums. Fragments (g = lane / 4,
// t = lane % 4): a0 (g, 2t..2t+1), a1 (g+8, 2t..), a2 (g, 2t+8..),
// a3 (g+8, 2t+8..); b0 (k 2t..2t+1, n g), b1 (k 2t+8.., n g);
// d0, d1 (g, 2t, 2t+1), d2, d3 (g+8, 2t, 2t+1).
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float bf16_lo(uint32_t w) {
    return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t w) {
    return __uint_as_float(w & 0xffff0000u);
}

// the positions [lo, hi) of split c of nc over row b's n valid positions,
// in whole tiles
__device__ __forceinline__ void split_range(int n, int c, int nc, int& lo,
                                            int& hi) {
    const int tiles = (n + T - 1) / T;
    const int per = (tiles + nc - 1) / nc;
    lo = min(c * per, tiles) * T;
    hi = min(n, (c + 1) * per * T);
}

// barrier `1 + gid` over the GTHREAD threads of group gid
__device__ __forceinline__ void group_sync(int gid) {
    asm volatile("bar.sync %0, %1;\n" ::"r"(gid + 1), "n"(GTHREAD)
                 : "memory");
}

template <int R, int DR, int MT>
__global__ void __launch_bounds__(NTHREAD, 1)
mla_decode_kernel(const __nv_bfloat16* __restrict__ q_lat,
                  const __nv_bfloat16* __restrict__ q_rope,
                  const __nv_bfloat16* __restrict__ c_kv,
                  const __nv_bfloat16* __restrict__ k_rope,
                  const void* __restrict__ kv_norm, int norm_bf16,
                  const int* __restrict__ q_pos, long long q_pos_stride,
                  const int* __restrict__ kv_valid, long long kv_valid_stride,
                  int S_max, int H, int hpg, float eps, float scale,
                  __nv_bfloat16* __restrict__ out) {
    using S = Shape<R, DR, MT>;
    extern __shared__ __align__(16) unsigned char smem[];
    __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);
    __nv_bfloat16* qr = reinterpret_cast<__nv_bfloat16*>(smem + S::QS);

    const int c = blockIdx.x, nc = gridDim.x, b = blockIdx.y;
    const int h0 = blockIdx.z * hpg, hn = min(H - h0, hpg);
    const int tid = threadIdx.x, gid = tid / GTHREAD;
    const int gt = tid % GTHREAD, w = gt >> 5, lane = tid & 31;
    const int g = lane >> 2, t4 = lane & 3;

    // this group's space
    unsigned char* gs = smem + S::QS + S::QR + gid * S::GROUP;
    __nv_bfloat16* kv = reinterpret_cast<__nv_bfloat16*>(gs);
    __nv_bfloat16* kr = reinterpret_cast<__nv_bfloat16*>(gs + S::KV);
    __nv_bfloat16* ps =
        reinterpret_cast<__nv_bfloat16*>(gs + S::KV + S::KR);
    float* red = reinterpret_cast<float*>(gs + S::KV + S::KR + S::PB);
    float* rsc = red + S::NRED * S::HB * S::FS;
    float* alph = rsc + S::HB * S::FS;
    float* mfin = alph + S::HB;
    float* lfin = mfin + S::HB;

    int n = min(kv_valid[b * kv_valid_stride], q_pos[b * q_pos_stride] + 1);
    n = max(0, min(n, S_max));
    int lo, hi;
    split_range(n, c, nc, lo, hi);
    // the group's tiles: gid, gid + G, ... of the split's
    const int ntiles = lo < hi ? (hi - lo + T - 1) / T : 0;
    const int nk = ntiles > gid ? (ntiles - gid + G - 1) / G : 0;

    auto load_tile = [&](int k, int st) {
        const int base = lo + (gid + G * k) * T;
        __nv_bfloat16* dkv = kv + (size_t)st * T * S::RS;
        __nv_bfloat16* dkr = kr + (size_t)st * T * S::DS;
        for (int i = gt; i < T * S::CH; i += GTHREAD) {
            const int row = i / S::CH, ch = i % S::CH, pos = base + row;
            const bool ok = pos < hi;
            cp_async_16(dkv + row * S::RS + ch * 8,
                        ok ? c_kv + ((size_t)b * S_max + pos) * R + ch * 8
                           : c_kv,
                        ok ? 16 : 0);
        }
        for (int i = gt; i < T * S::CHD; i += GTHREAD) {
            const int row = i / S::CHD, ch = i % S::CHD, pos = base + row;
            const bool ok = pos < hi;
            cp_async_16(dkr + row * S::DS + ch * 8,
                        ok ? k_rope + ((size_t)b * S_max + pos) * DR + ch * 8
                           : k_rope,
                        ok ? 16 : 0);
        }
    };

#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
        if (s < nk) load_tile(s, s);
        ptx::cp_async_commit();
    }

    // the queries (zero rows for padded heads, zero rope columns past DR),
    // and the rope tiles' padded columns, which no copy writes
    for (int i = tid; i < S::HB * S::CH; i += NTHREAD) {
        const int h = i / S::CH, ch = i % S::CH;
        uint4 v = make_uint4(0, 0, 0, 0);
        if (h < hn)
            v = *reinterpret_cast<const uint4*>(
                q_lat + ((size_t)b * H + h0 + h) * R + ch * 8);
        *reinterpret_cast<uint4*>(qs + h * S::RS + ch * 8) = v;
    }
    for (int i = tid; i < S::HB * S::DRP; i += NTHREAD) {
        const int h = i / S::DRP, d = i % S::DRP;
        qr[h * S::DS + d] = (h < hn && d < DR)
                                ? q_rope[((size_t)b * H + h0 + h) * DR + d]
                                : __float2bfloat16_rn(0.f);
    }
    if constexpr (S::DRP > DR) {
        for (int i = gt; i < STAGES * T * (S::DRP - DR); i += GTHREAD) {
            const int row = i / (S::DRP - DR), d = DR + i % (S::DRP - DR);
            kr[row * S::DS + d] = __float2bfloat16_rn(0.f);
        }
    }
    __syncthreads();
    // this lane's kv_norm values, for the columns it normalises
    float sc[S::CPL][8];
#pragma unroll
    for (int k = 0; k < S::CPL; ++k) {
        const int ch = min(lane + 32 * k, S::CH - 1);
        if (norm_bf16) {
            const uint4 v = *reinterpret_cast<const uint4*>(
                reinterpret_cast<const __nv_bfloat16*>(kv_norm) + ch * 8);
            const uint32_t u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                sc[k][2 * e] = bf16_lo(u[e]);
                sc[k][2 * e + 1] = bf16_hi(u[e]);
            }
        } else {
            const float4* f =
                reinterpret_cast<const float4*>(kv_norm) + ch * 2;
            const float4 f0 = f[0], f1 = f[1];
            sc[k][0] = f0.x, sc[k][1] = f0.y, sc[k][2] = f0.z, sc[k][3] = f0.w;
            sc[k][4] = f1.x, sc[k][5] = f1.y, sc[k][6] = f1.z, sc[k][7] = f1.w;
        }
    }

    float acc[MT][S::NTW][4];
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int i = 0; i < S::NTW; ++i)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[m][i][e] = 0.f;
    // each owned head's running max, and this lane's part of its sum
    float m_run[S::HPW], l_lane[S::HPW];
#pragma unroll
    for (int i = 0; i < S::HPW; ++i) {
        m_run[i] = -INFINITY;
        l_lane[i] = 0.f;
    }

    // the second group starts once the first has normalised its first
    // tile, so that the two groups' phases alternate (barrier 3)
    if (gid == 1 && ntiles)
        asm volatile("bar.sync 3, %0;\n" ::"n"(NTHREAD) : "memory");
    for (int k = 0; k < nk; ++k) {
        ptx::cp_async_wait<STAGES - 2>();
        group_sync(gid);
        if (k + STAGES - 1 < nk)
            load_tile(k + STAGES - 1, (k + STAGES - 1) % STAGES);
        ptx::cp_async_commit();
        __nv_bfloat16* tkv = kv + (size_t)(k % STAGES) * T * S::RS;
        const __nv_bfloat16* tkr = kr + (size_t)(k % STAGES) * T * S::DS;
        const int base = lo + (gid + G * k) * T;

        // 1. rms_norm of the warp's rows w, w + W, ..., in place, rounded
        //    to bf16; the rows' loads, sums and shuffles side by side
        {
            uint32_t u[RPW][S::CPL][4];
            float ss[RPW];
#pragma unroll
            for (int r = 0; r < RPW; ++r) {
                ss[r] = 0.f;
#pragma unroll
                for (int k2 = 0; k2 < S::CPL; ++k2) {
                    const int ch = lane + 32 * k2;
                    uint4 v = make_uint4(0, 0, 0, 0);
                    if (ch < S::CH)
                        v = *reinterpret_cast<const uint4*>(
                            tkv + (w + W * r) * S::RS + ch * 8);
                    u[r][k2][0] = v.x;
                    u[r][k2][1] = v.y;
                    u[r][k2][2] = v.z;
                    u[r][k2][3] = v.w;
                }
            }
#pragma unroll
            for (int r = 0; r < RPW; ++r)
#pragma unroll
                for (int k2 = 0; k2 < S::CPL; ++k2)
#pragma unroll
                    for (int e = 0; e < 4; ++e) {
                        const float a = bf16_lo(u[r][k2][e]),
                                    d = bf16_hi(u[r][k2][e]);
                        ss[r] += a * a;
                        ss[r] += d * d;
                    }
#pragma unroll
            for (int o = 16; o; o >>= 1)
#pragma unroll
                for (int r = 0; r < RPW; ++r)
                    ss[r] += __shfl_xor_sync(0xffffffffu, ss[r], o);
#pragma unroll
            for (int r = 0; r < RPW; ++r) {
                const float inv = rsqrtf(ss[r] * (1.0f / R) + eps);
#pragma unroll
                for (int k2 = 0; k2 < S::CPL; ++k2) {
                    const int ch = lane + 32 * k2;
                    if (ch < S::CH) {
                        uint4 v;
                        uint32_t* o = reinterpret_cast<uint32_t*>(&v);
#pragma unroll
                        for (int e = 0; e < 4; ++e)
                            o[e] = ptx::pack_bf16(
                                __fmul_rn(__fmul_rn(bf16_lo(u[r][k2][e]),
                                                    inv),
                                          sc[k2][2 * e]),
                                __fmul_rn(__fmul_rn(bf16_hi(u[r][k2][e]),
                                                    inv),
                                          sc[k2][2 * e + 1]));
                        *reinterpret_cast<uint4*>(
                            tkv + (w + W * r) * S::RS + ch * 8) = v;
                    }
                }
            }
        }
        group_sync(gid);
        if (gid == 0 && k == 0)
            asm volatile("bar.arrive 3, %0;\n" ::"n"(NTHREAD) : "memory");

        // 2. partial scores: the latent over this warp's k blocks, the rope
        //    over (head tile, 8 positions) pairs
        if (w < S::NRED) {
#pragma unroll
            for (int m = 0; m < MT; ++m) {
                float sa[T / 8][4];
#pragma unroll
                for (int j = 0; j < T / 8; ++j)
#pragma unroll
                    for (int e = 0; e < 4; ++e) sa[j][e] = 0.f;
#pragma unroll
                for (int i = 0; i < S::KBW; ++i) {
                    const int kb = w * S::KBW + i;
                    if (kb < S::KB) {
                        uint32_t a[4];
                        ldsm_x4(a, qs + (m * 16 + (lane & 15)) * S::RS +
                                       kb * 16 + (lane >> 4) * 8);
#pragma unroll
                        for (int j = 0; j < T / 16; ++j) {
                            const int mi = lane >> 3;
                            uint32_t bb[4];
                            ldsm_x4(bb, tkv + (j * 16 + (lane & 7) +
                                               (mi >> 1) * 8) * S::RS +
                                            kb * 16 + (mi & 1) * 8);
                            mma(sa[2 * j], a, bb[0], bb[1]);
                            mma(sa[2 * j + 1], a, bb[2], bb[3]);
                        }
                    }
                }
                float* rw = red + (w * S::HB + m * 16) * S::FS;
#pragma unroll
                for (int j = 0; j < T / 8; ++j) {
                    *reinterpret_cast<float2*>(rw + g * S::FS + j * 8 +
                                               2 * t4) =
                        make_float2(sa[j][0], sa[j][1]);
                    *reinterpret_cast<float2*>(rw + (g + 8) * S::FS + j * 8 +
                                               2 * t4) =
                        make_float2(sa[j][2], sa[j][3]);
                }
            }
        }
        for (int pr = w; pr < MT * (T / 8); pr += W) {
            const int m = pr / (T / 8), j = pr % (T / 8);
            float sr[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
            for (int kb = 0; kb < S::RB; ++kb) {
                uint32_t a[4], bb[2];
                ldsm_x4(a, qr + (m * 16 + (lane & 15)) * S::DS + kb * 16 +
                               (lane >> 4) * 8);
                ldsm_x2(bb, tkr + (j * 8 + (lane & 7)) * S::DS + kb * 16 +
                                ((lane >> 3) & 1) * 8);
                mma(sr, a, bb[0], bb[1]);
            }
            float* rw = rsc + (m * 16) * S::FS + j * 8 + 2 * t4;
            *reinterpret_cast<float2*>(rw + g * S::FS) =
                make_float2(sr[0], sr[1]);
            *reinterpret_cast<float2*>(rw + (g + 8) * S::FS) =
                make_float2(sr[2], sr[3]);
        }
        group_sync(gid);

        // 3. scores, mask, online softmax: a warp a head, a lane a position
        {
            float sv[S::HPW], mx[S::HPW];
#pragma unroll
            for (int i = 0; i < S::HPW; ++i) {
                const int h = w + W * i;
                float sn = 0.f;
#pragma unroll
                for (int q = 0; q < S::NRED; ++q)
                    sn += red[(q * S::HB + h) * S::FS + lane];
                sv[i] = (sn + rsc[h * S::FS + lane]) * scale;
                if (base + lane >= hi) sv[i] = -INFINITY;
                mx[i] = sv[i];
            }
#pragma unroll
            for (int o = 16; o; o >>= 1)
#pragma unroll
                for (int i = 0; i < S::HPW; ++i)
                    mx[i] = fmaxf(mx[i],
                                  __shfl_xor_sync(0xffffffffu, mx[i], o));
#pragma unroll
            for (int i = 0; i < S::HPW; ++i) {
                const int h = w + W * i;
                const float mnew = fmaxf(m_run[i], mx[i]);
                float alpha = 1.f, p = 0.f;
                if (mnew != -INFINITY) {
                    alpha = expf(m_run[i] - mnew);
                    p = expf(sv[i] - mnew);
                }
                l_lane[i] = l_lane[i] * alpha + p;
                m_run[i] = mnew;
                ps[h * S::PS + lane] = __float2bfloat16_rn(p);
                if (lane == 0) alph[h] = alpha;
            }
        }
        group_sync(gid);

        // 4. o = o * alpha + p . ckn over this warp's output columns
        if (w * S::NTW < S::NT) {
#pragma unroll
            for (int m = 0; m < MT; ++m) {
                const float lo_a = alph[m * 16 + g],
                            hi_a = alph[m * 16 + g + 8];
#pragma unroll
                for (int i = 0; i < S::NTW; ++i) {
                    acc[m][i][0] *= lo_a;
                    acc[m][i][1] *= lo_a;
                    acc[m][i][2] *= hi_a;
                    acc[m][i][3] *= hi_a;
                }
            }
#pragma unroll
            for (int ks = 0; ks < T / 16; ++ks) {
                uint32_t a[MT][4];
#pragma unroll
                for (int m = 0; m < MT; ++m)
                    ldsm_x4(a[m], ps + (m * 16 + (lane & 15)) * S::PS +
                                      ks * 16 + (lane >> 4) * 8);
                if constexpr (S::NTW % 2 == 0) {
#pragma unroll
                    for (int i = 0; i < S::NTW; i += 2) {
                        const int nt = w * S::NTW + i;
                        if (nt < S::NT) {
                            const int mi = lane >> 3;
                            uint32_t bb[4];
                            ldsm_x4_t(bb, tkv + (ks * 16 + (lane & 7) +
                                                 (mi & 1) * 8) * S::RS +
                                              nt * 8 + (mi >> 1) * 8);
#pragma unroll
                            for (int m = 0; m < MT; ++m) {
                                mma(acc[m][i], a[m], bb[0], bb[1]);
                                mma(acc[m][i + 1], a[m], bb[2], bb[3]);
                            }
                        }
                    }
                } else {
#pragma unroll
                    for (int i = 0; i < S::NTW; ++i) {
                        const int nt = w * S::NTW + i;
                        if (nt < S::NT) {
                            uint32_t bb[2];
                            ldsm_x2_t(bb, tkv + (ks * 16 + (lane & 7) +
                                                 ((lane >> 3) & 1) * 8) *
                                                    S::RS +
                                              nt * 8);
#pragma unroll
                            for (int m = 0; m < MT; ++m)
                                mma(acc[m][i], a[m], bb[0], bb[1]);
                        }
                    }
                }
            }
        }
    }
    ptx::cp_async_wait<0>();

    // each group's (max, sum) a head; the second group's accumulator into
    // its own space, for the first
#pragma unroll
    for (int i = 0; i < S::HPW; ++i) {
        float l = l_lane[i];
#pragma unroll
        for (int o = 16; o; o >>= 1) l += __shfl_xor_sync(0xffffffffu, l, o);
        if (lane == 0) {
            mfin[w + W * i] = m_run[i];
            lfin[w + W * i] = l;
        }
    }
    __syncthreads();
    float* other = reinterpret_cast<float*>(smem + S::QS + S::QR + S::GROUP);
    if (gid == 1) {
#pragma unroll
        for (int m = 0; m < MT; ++m)
#pragma unroll
            for (int half = 0; half < 2; ++half)
#pragma unroll
                for (int i = 0; i < S::NTW; ++i) {
                    const int nt = w * S::NTW + i;
                    if (nt >= S::NT) continue;
                    *reinterpret_cast<float2*>(
                        other + (m * 16 + g + 8 * half) * R + nt * 8 +
                        2 * t4) = make_float2(acc[m][i][2 * half],
                                              acc[m][i][2 * half + 1]);
                }
    }
    __syncthreads();
    // the block's (O, max, sum): the two groups' merged by the first, O
    // into the first group's space (its ring is drained)
    float* xo = reinterpret_cast<float*>(smem + S::QS + S::QR);
    float* xm = reinterpret_cast<float*>(smem + S::QS + S::QR + G * S::GROUP);
    float* xl = xm + S::HB;
    float* inv_l = xl + S::HB;
    float* wts = inv_l + S::HB;      // [HB][MAX_SPLITS]
    if (gid == 0) {
        const float* m1 = reinterpret_cast<const float*>(
            smem + S::QS + S::QR + 2 * S::GROUP - S::VEC) + S::HB;
        const float* l1 = m1 + S::HB;
#pragma unroll
        for (int m = 0; m < MT; ++m) {
#pragma unroll
            for (int half = 0; half < 2; ++half) {
                const int h = m * 16 + g + 8 * half;
                // the two groups' weights against their common max (none
                // for a group that saw no position)
                const float a0 = mfin[h], a1 = m1[h], M = fmaxf(a0, a1);
                const float w0 = lfin[h] > 0.f ? expf(a0 - M) : 0.f;
                const float w1 = l1[h] > 0.f ? expf(a1 - M) : 0.f;
#pragma unroll
                for (int i = 0; i < S::NTW; ++i) {
                    const int nt = w * S::NTW + i;
                    if (nt >= S::NT) continue;
                    const int col = nt * 8 + 2 * t4;
                    const float2 o1 =
                        *reinterpret_cast<const float2*>(other + h * R + col);
                    *reinterpret_cast<float2*>(xo + h * R + col) =
                        make_float2(acc[m][i][2 * half] * w0 + o1.x * w1,
                                    acc[m][i][2 * half + 1] * w0 + o1.y * w1);
                }
                if (w == 0 && t4 == 0) {
                    xm[h] = M;
                    xl[h] = lfin[h] * w0 + l1[h] * w1;
                }
            }
        }
    }
    // the row's blocks (a cluster, in split order) merged: each block
    // takes a slice of the columns from every block's shared memory
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();
    if (tid < hn) {
        float M = -INFINITY, L = 0.f;
        for (int q = 0; q < nc; ++q) {
            if (*cluster.map_shared_rank(xl + tid, q) > 0.f)
                M = fmaxf(M, *cluster.map_shared_rank(xm + tid, q));
        }
        for (int q = 0; q < nc; ++q) {
            const float lq = *cluster.map_shared_rank(xl + tid, q);
            const float wq =
                lq > 0.f ? expf(*cluster.map_shared_rank(xm + tid, q) - M)
                         : 0.f;
            wts[tid * MAX_SPLITS + q] = wq;
            L += lq * wq;
        }
        inv_l[tid] = 1.f / L;       // no valid position: inf, then NaN
    }
    __syncthreads();
    const int cs = ((R + nc - 1) / nc + 3) / 4 * 4;
    const int c0 = min(R, c * cs), n4 = (min(R, c0 + cs) - c0) / 4;
    for (int i = tid; i < hn * n4; i += NTHREAD) {
        const int h = i / n4, col = c0 + 4 * (i % n4);
        float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
        for (int q = 0; q < nc; ++q) {
            const float wq = wts[h * MAX_SPLITS + q];
            if (wq == 0.f) continue;
            const float4 v = *reinterpret_cast<const float4*>(
                cluster.map_shared_rank(xo + h * R + col, q));
            o.x += v.x * wq;
            o.y += v.y * wq;
            o.z += v.z * wq;
            o.w += v.w * wq;
        }
        const float il = inv_l[h];
        *reinterpret_cast<uint2*>(out + ((size_t)b * H + h0 + h) * R + col) =
            make_uint2(ptx::pack_bf16(o.x * il, o.y * il),
                       ptx::pack_bf16(o.z * il, o.w * il));
    }
    // no block leaves while another reads its shared memory
    cluster.sync();
}

template <int R, int DR, int MT>
int launch_shape(const void* q_lat, const void* q_rope, const void* c_kv,
                 const void* k_rope, const void* kv_norm, int norm_bf16,
                 const void* q_pos, long long q_pos_stride,
                 const void* kv_valid, long long kv_valid_stride, int B,
                 int S_max, int H, int splits, int groups, float eps,
                 float scale, void* out, cudaStream_t stream) {
    using S = Shape<R, DR, MT>;
    auto kern = mla_decode_kernel<R, DR, MT>;
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)S::SMEM);
    if (err != cudaSuccess) return (int)err;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(splits, B, groups);
    cfg.blockDim = dim3(NTHREAD);
    cfg.dynamicSmemBytes = S::SMEM;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = splits;   // a row's splits: one cluster
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(
        &cfg, kern, static_cast<const __nv_bfloat16*>(q_lat),
        static_cast<const __nv_bfloat16*>(q_rope),
        static_cast<const __nv_bfloat16*>(c_kv),
        static_cast<const __nv_bfloat16*>(k_rope), kv_norm, norm_bf16,
        static_cast<const int*>(q_pos), q_pos_stride,
        static_cast<const int*>(kv_valid), kv_valid_stride, S_max, H,
        (H + groups - 1) / groups, eps, scale,
        static_cast<__nv_bfloat16*>(out));
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
}

}  // namespace

// q_lat [B, 1, H, R], q_rope [B, 1, H, DR], c_kv [B, S_max, R], k_rope
// [B, S_max, DR] bf16, contiguous, 16-byte aligned; kv_norm [R] (bf16
// when norm_bf16, else fp32); q_pos and kv_valid int32, row b at b times
// its stride; out [B, 1, H, R] bf16. The heads go in `groups` groups
// of at most 16 mt heads a block, mt = (ceil(H / groups) + 15) / 16, and
// each row's positions in `splits` (at most 8: a cluster). Returns
// cudaErrorInvalidValue for a shape it was not built for.
extern "C" int mla_decode_launch(
    const void* q_lat, const void* q_rope, const void* c_kv,
    const void* k_rope, const void* kv_norm, int norm_bf16, const void* q_pos,
    long long q_pos_stride, const void* kv_valid, long long kv_valid_stride,
    int B, int S_max, int H, int R, int DR, int splits, int groups,
    float eps, float scale, void* out, void* stream) {
    if (splits < 1 || splits > MAX_SPLITS || groups < 1 || groups > H)
        return (int)cudaErrorInvalidValue;
    const int mt = ((H + groups - 1) / groups + 15) / 16;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
#define MLA_ARGS                                                           \
    q_lat, q_rope, c_kv, k_rope, kv_norm, norm_bf16, q_pos, q_pos_stride,  \
        kv_valid, kv_valid_stride, B, S_max, H, splits, groups, eps, scale, \
        out, s
    if (R == 512 && DR == 64) {
        if (mt == 1) return launch_shape<512, 64, 1>(MLA_ARGS);
    } else if (R == 256 && DR == 32) {
        if (mt == 1) return launch_shape<256, 32, 1>(MLA_ARGS);
        if (mt == 2) return launch_shape<256, 32, 2>(MLA_ARGS);
    } else if (R == 32 && DR == 8) {
        if (mt == 1) return launch_shape<32, 8, 1>(MLA_ARGS);
    }
#undef MLA_ARGS
    return (int)cudaErrorInvalidValue;
}
