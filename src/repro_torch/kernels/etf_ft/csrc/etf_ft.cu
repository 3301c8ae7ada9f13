// Decision kernels of the DAS simulator for Hopper (sm_90a).
//
// Replaces the TPU Pallas kernels of repro/kernels/etf_ft/kernel.py:
//   etf_ft_search_masked (kernel.py:122) -> etf_search_fixed<16, 19, true> at
//       the simulator's shape, etf_search_kernel<true> at any other
//   etf_ft_search (kernel.py:72)         -> the same two with MASKED = false
//   push_rows (kernel.py:181)            -> avail_rows_kernel on the
//       simulator's path, which gathers its own inputs from the simulator's
//       state; push_rows_kernel takes them ready-made
//
// Each kernel keeps the plain PyTorch version's operations in the same
// order (repro_torch/kernels/etf_ft/ref.py), so the two agree bit for
// bit: the build uses -fmad=false and the adds and multiplies are the
// explicitly rounded intrinsics, so nothing is contracted into an FMA.
// max() propagates NaN as torch.maximum does; fmaxf alone would drop a NaN
// and let it slip past the isfinite mask.
//
// Bound on the H100 (3.35 TB/s HBM3): at the simulator's S = 560 lanes,
// R = 16 ready slots and P = 19 PEs the search reads about 1.4 MB (avail
// and exec rows, 0.425 us), and avail_rows reads the tasks' predecessor
// state and writes [560, 4, 19] rows (about 0.1 us). Both are below the
// cost of one launch, so in practice the launch floor bounds them, not
// bytes or operations. Two things follow. On the device, the search
// takes one memory round trip: it issues every load of a scenario (three
// float4 per lane per matrix, the slot and PE masks as one ballot each)
// before its first compare; and avail_rows replaces the dozen gather,
// where and index launches that used to build its inputs with one launch,
// whose gathers follow the chain task -> predecessors -> their state. On
// the host, the simulator records POLL_EVERY super-steps in one CUDA graph
// (core/simulator.py), so that a launch costs no host time.
//
// Plain C interface, loaded with ctypes. Every entry point launches on
// the caller's stream, does not synchronise, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;

// float32(3.4e38), the reference's BIG fill for a masked cell
__device__ __forceinline__ float big_f() { return __int_as_float(0x7f7fc99e); }
__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

__device__ __forceinline__ float nan_max(float a, float b) {
    if (a != a) return a;
    if (b != b) return b;
    return fmaxf(a, b);
}

// The finish time of one cell: max(max(avail, free), now) + exec, rounded
// once, as `ref._finish_times`.
__device__ __forceinline__ float finish_time(float a, float f, float nw,
                                             float e) {
    return __fadd_rn(nan_max(nan_max(a, f), nw), e);
}

// Keep the smaller (value, flat index) of two lanes' minima: the smaller
// value, and on a tie the smaller index, so the first global minimum wins.
__device__ __forceinline__ void warp_first_min(float& best, int& bidx) {
    for (int off = 16; off > 0; off >>= 1) {
        const float ov = __shfl_down_sync(kFull, best, off);
        const int oi = __shfl_down_sync(kFull, bidx, off);
        if (ov < best || (ov == best && oi < bidx)) {
            best = ov;
            bidx = oi;
        }
    }
}

// The generic search, for any R and P: one warp per scenario. Lane l walks
// cells l, l + 32, ... of the row-major [R, P] matrix and keeps its first
// minimum (strict <), then the shuffle reduction picks the first global
// minimum.
template <bool MASKED>
__global__ void etf_search_kernel(const float* __restrict__ avail,
                                  const float* __restrict__ free_t,
                                  const float* __restrict__ exec_t,
                                  const float* __restrict__ now,
                                  const uint8_t* __restrict__ slot_ok,
                                  const uint8_t* __restrict__ pe_alive,
                                  float* __restrict__ ft_min,
                                  int32_t* __restrict__ slot,
                                  int32_t* __restrict__ pe,
                                  uint8_t* __restrict__ feasible,
                                  int S, int R, int P) {
    const int s = (int)((blockIdx.x * (unsigned)blockDim.x + threadIdx.x) >> 5);
    const int lane = threadIdx.x & 31;
    if (s >= S) return;  // uniform across the warp
    const int RP = R * P;
    const float* a = avail + (size_t)s * RP;
    const float* e = exec_t + (size_t)s * RP;
    const float* f = free_t + (size_t)s * P;
    const float nw = now[s];
    float best = __int_as_float(0x7f800000);  // +inf: any cell beats it
    int bidx = 0x7fffffff;
    for (int c = lane; c < RP; c += 32) {
        const int r = c / P;
        const int p = c - r * P;
        const float ft = finish_time(a[c], f[p], nw, e[c]);
        bool ok = isfinite(ft);
        if (MASKED) {
            ok = ok && slot_ok[(size_t)s * R + r] != 0;
            if (pe_alive != nullptr) ok = ok && pe_alive[(size_t)s * P + p] != 0;
        }
        const float v = ok ? ft : big_f();
        if (v < best) {
            best = v;
            bidx = c;
        }
    }
    warp_first_min(best, bidx);
    if (lane == 0) {
        ft_min[s] = best;
        slot[s] = bidx / P;
        pe[s] = bidx % P;
        if (MASKED) feasible[s] = best < big_f() ? 1 : 0;
    }
}

// The search at a fixed [R, P], one warp per scenario, every load issued
// before the first compare. A scenario's R * P cells are R * P / 4 float4
// (1,216 bytes at 16 x 19: 16-byte aligned at every scenario), and lane l
// takes float4 l, l + 32, l + 64 of avail and of exec at once. The free
// row comes in one float a lane and reaches each cell by a shuffle; the
// slot and PE masks come in one byte a lane and become bit masks by a
// ballot, so each row's slot_ok is read once. With the sizes fixed the cell
// loop unrolls fully; the row and column of a float4's first cell come
// from a division by the constant P (a multiply), then step along.
//
// Each lane walks its cells in increasing flat index (float4 k, then its
// four cells) and keeps its first minimum (strict <); the shuffle
// reduction then keeps the first global minimum, as the generic kernel.
template <int R, int P, bool MASKED>
__global__ void etf_search_fixed(const float* __restrict__ avail,
                                 const float* __restrict__ free_t,
                                 const float* __restrict__ exec_t,
                                 const float* __restrict__ now,
                                 const uint8_t* __restrict__ slot_ok,
                                 const uint8_t* __restrict__ pe_alive,
                                 float* __restrict__ ft_min,
                                 int32_t* __restrict__ slot,
                                 int32_t* __restrict__ pe,
                                 uint8_t* __restrict__ feasible, int S) {
    constexpr int V = R * P / 4;          // float4 a scenario
    constexpr int K = (V + 31) / 32;      // float4 a lane
    static_assert(R * P % 4 == 0, "a scenario must be whole float4");
    static_assert(R <= 32 && P <= 32, "one ballot per mask");
    static_assert(128 * K / P < 32, "rows past the last float4 stay < 32");
    const int s = (int)((blockIdx.x * (unsigned)blockDim.x + threadIdx.x) >> 5);
    const int lane = threadIdx.x & 31;
    if (s >= S) return;  // uniform across the warp
    const float4* a4 = reinterpret_cast<const float4*>(avail) + (size_t)s * V;
    const float4* e4 = reinterpret_cast<const float4*>(exec_t) + (size_t)s * V;
    float4 av[K], ev[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
        const int j = lane + 32 * k;
        const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
        av[k] = j < V ? __ldg(a4 + j) : zero;
        ev[k] = j < V ? __ldg(e4 + j) : zero;
    }
    const float fr = lane < P ? __ldg(free_t + (size_t)s * P + lane) : 0.f;
    const float nw = __ldg(now + s);
    unsigned rmask = kFull, pmask = kFull;
    if (MASKED) {
        rmask = __ballot_sync(
            kFull, lane < R && __ldg(slot_ok + (size_t)s * R + lane) != 0);
        if (pe_alive != nullptr)
            pmask = __ballot_sync(
                kFull,
                lane < P && __ldg(pe_alive + (size_t)s * P + lane) != 0);
    }
    float best = __int_as_float(0x7f800000);  // +inf: any cell beats it
    int bidx = 0x7fffffff;
#pragma unroll
    for (int k = 0; k < K; ++k) {
        const int j = lane + 32 * k;
        const int c0 = 4 * j;
        int r = c0 / P;
        int p = c0 - r * P;
        const float a[4] = {av[k].x, av[k].y, av[k].z, av[k].w};
        const float e[4] = {ev[k].x, ev[k].y, ev[k].z, ev[k].w};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
            // every lane shuffles, also past the last float4 (p stays < P)
            const float f = __shfl_sync(kFull, fr, p);
            const float ft = finish_time(a[q], f, nw, e[q]);
            bool ok = isfinite(ft);
            if (MASKED) ok = ok && ((rmask >> r) & 1u) && ((pmask >> p) & 1u);
            const float v = ok ? ft : big_f();
            if (j < V && v < best) {
                best = v;
                bidx = c0 + q;
            }
            if (++p == P) {
                p = 0;
                ++r;
            }
        }
    }
    warp_first_min(best, bidx);
    if (lane == 0) {
        ft_min[s] = best;
        slot[s] = bidx / P;
        pe[s] = bidx - (bidx / P) * P;
        if (MASKED) feasible[s] = best < big_f() ? 1 : 0;
    }
}

// One push row: the running max over the MP predecessors of
// pfin + cost * [pcl != cl] (-inf for an invalid one), starting from -inf,
// then the max with the row's base. pred(j, pfin, cost, pcl, pv) reads
// predecessor j. Shared by push_rows_kernel and avail_rows_kernel. The
// bracket is a select, as XLA computes the reference's multiply by a
// converted bool: a same-cluster predecessor adds +0.0 whatever its cost.
template <class Pred>
__device__ __forceinline__ float push_row(int MP, int cl, float base,
                                          Pred pred) {
    float m = neg_inf();
#pragma unroll 4
    for (int j = 0; j < MP; ++j) {
        float pfin, cost;
        int pcl;
        bool pv;
        pred(j, pfin, cost, pcl, pv);
        const float c = pv ? __fadd_rn(pfin, pcl != cl ? cost : 0.0f)
                           : neg_inf();
        m = nan_max(m, c);
    }
    return nan_max(m, base);
}

// One thread per output (s, k, p), from ready-made [S*K, MP] inputs.
__global__ void push_rows_kernel(const float* __restrict__ pfin,
                                 const float* __restrict__ cost,
                                 const int32_t* __restrict__ pcl,
                                 const uint8_t* __restrict__ pv,
                                 const int32_t* __restrict__ pe_cluster,
                                 const float* __restrict__ bases,
                                 float* __restrict__ rows,
                                 int SK, int MP, int P) {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= (long long)SK * P) return;
    const int p = (int)(i % P);
    const long long sk = i / P;
    rows[i] = push_row(MP, pe_cluster[p], bases[sk],
                       [&](int j, float& f, float& c, int& cl, bool& v) {
                           const long long q = sk * MP + j;
                           f = pfin[q];
                           c = cost[q];
                           cl = pcl[q];
                           v = pv[q] != 0;
                       });
}

// One thread per output (s, k, p), reading the simulator's state in place:
// task t = tasks[s, k] (in [0, T)), its predecessors preds[s, t, :n_preds],
// and for each predecessor q its finish time, its output size times the
// NoC rate (one rounded multiply) and the cluster of the PE it ran on, in
// lane s of the flat [S*T + 1] buffers. The gathers of
// ref.avail_rows_reference, then push_rows' arithmetic.
__global__ void avail_rows_kernel(const int64_t* __restrict__ tasks,
                                  const float* __restrict__ finish,
                                  const int64_t* __restrict__ pe_of,
                                  const int64_t* __restrict__ preds,
                                  const int64_t* __restrict__ n_preds,
                                  const float* __restrict__ out_kb,
                                  const float* __restrict__ us_per_kb,
                                  const int32_t* __restrict__ pe_cluster,
                                  const float* __restrict__ bases,
                                  float* __restrict__ rows,
                                  int S, int K, int T, int MP, int P) {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= (long long)S * K * P) return;
    const int p = (int)(i % P);
    const long long sk = i / P;
    const long long lane0 = (sk / K) * T;        // lane s's first task
    const long long row = lane0 + tasks[sk];
    const long long np = n_preds[row];
    const float upk = *us_per_kb;
    rows[i] = push_row(MP, pe_cluster[p], bases[sk],
                       [&](int j, float& f, float& c, int& cl, bool& v) {
                           // issued beside n_preds: the row holds MP entries
                           const long long q = preds[row * MP + j];
                           v = j < np;
                           f = neg_inf();
                           c = 0.f;
                           cl = 0;
                           if (v) {
                               const long long qi = lane0 + (q < 0 ? 0 : q);
                               const long long e = pe_of[qi];
                               f = finish[qi];
                               c = __fmul_rn(out_kb[qi], upk);
                               cl = pe_cluster[e < 0 ? 0 : e];
                           }
                       });
}

constexpr int kSearchThreads = 128;  // 4 scenarios (warps) per block
constexpr int kRowThreads = 128;
constexpr int kPathR = 16;   // the simulator's R_MAX (soc.ETF_LAT_MAX_N)
constexpr int kPathP = 19;   // the default SoC's PEs

// `fixed` picks the kernel, as the caller decided and counted it: the
// fixed one (the path's shape, both matrices 16-byte aligned, else
// cudaErrorInvalidValue) or the generic one.
template <bool MASKED>
int launch_search(const float* avail, const float* free_t, const float* exec_t,
                  const float* now, const uint8_t* slot_ok,
                  const uint8_t* pe_alive, float* ft_min, int32_t* slot,
                  int32_t* pe, uint8_t* feasible, int S, int R, int P,
                  int fixed, cudaStream_t stream) {
    const int warps = kSearchThreads / 32;
    const int blocks = (S + warps - 1) / warps;
    const bool aligned = (((uintptr_t)avail | (uintptr_t)exec_t) & 15) == 0;
    if (fixed) {
        if (R != kPathR || P != kPathP || !aligned)
            return (int)cudaErrorInvalidValue;
        etf_search_fixed<kPathR, kPathP, MASKED>
            <<<blocks, kSearchThreads, 0, stream>>>(
                avail, free_t, exec_t, now, slot_ok, pe_alive, ft_min, slot,
                pe, feasible, S);
    } else {
        etf_search_kernel<MASKED><<<blocks, kSearchThreads, 0, stream>>>(
            avail, free_t, exec_t, now, slot_ok, pe_alive, ft_min, slot, pe,
            feasible, S, R, P);
    }
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" int etf_ft_search_masked_launch(
        const float* avail, const float* free_t, const float* exec_t,
        const float* now, const uint8_t* slot_ok, const uint8_t* pe_alive,
        float* ft_min, int32_t* slot, int32_t* pe, uint8_t* feasible,
        int S, int R, int P, int fixed, void* stream) {
    return launch_search<true>(avail, free_t, exec_t, now, slot_ok, pe_alive,
                               ft_min, slot, pe, feasible, S, R, P, fixed,
                               (cudaStream_t)stream);
}

extern "C" int etf_ft_search_launch(
        const float* avail, const float* free_t, const float* exec_t,
        const float* now, float* ft_min, int32_t* slot, int32_t* pe,
        int S, int R, int P, int fixed, void* stream) {
    return launch_search<false>(avail, free_t, exec_t, now, nullptr, nullptr,
                                ft_min, slot, pe, nullptr, S, R, P, fixed,
                                (cudaStream_t)stream);
}

extern "C" int push_rows_launch(
        const float* pfin, const float* cost, const int32_t* pcl,
        const uint8_t* pv, const int32_t* pe_cluster, const float* bases,
        float* rows, int SK, int MP, int P, void* stream) {
    const long long n = (long long)SK * P;
    const int blocks = (int)((n + kRowThreads - 1) / kRowThreads);
    push_rows_kernel<<<blocks, kRowThreads, 0, (cudaStream_t)stream>>>(
        pfin, cost, pcl, pv, pe_cluster, bases, rows, SK, MP, P);
    return (int)cudaGetLastError();
}

extern "C" int avail_rows_launch(
        const int64_t* tasks, const float* finish, const int64_t* pe_of,
        const int64_t* preds, const int64_t* n_preds, const float* out_kb,
        const float* us_per_kb, const int32_t* pe_cluster, const float* bases,
        float* rows, int S, int K, int T, int MP, int P, void* stream) {
    const long long n = (long long)S * K * P;
    const int blocks = (int)((n + kRowThreads - 1) / kRowThreads);
    avail_rows_kernel<<<blocks, kRowThreads, 0, (cudaStream_t)stream>>>(
        tasks, finish, pe_of, preds, n_preds, out_kb, us_per_kb, pe_cluster,
        bases, rows, S, K, T, MP, P);
    return (int)cudaGetLastError();
}
