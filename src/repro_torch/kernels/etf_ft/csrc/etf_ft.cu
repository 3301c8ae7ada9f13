// Decision kernels of the DAS simulator for Hopper (sm_90a).
//
// Replaces the TPU Pallas kernels of repro/kernels/etf_ft/kernel.py:
//   etf_ft_search_masked  -> etf_search_kernel<true>   (kernel.py:122)
//   etf_ft_search         -> etf_search_kernel<false>  (kernel.py:72)
//   push_rows             -> push_rows_kernel          (kernel.py:181)
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
// and exec rows, 0.43 us) and push_rows about 0.3 MB (about 0.1 us). Both
// are far below the cost of one launch, so launch latency bounds them,
// not bytes or operations. The design is therefore the simplest correct
// one: one warp per scenario for the search, one thread per output for
// the rows. A later design folds both into one fused super-step kernel
// (or a CUDA graph of the step) so that the launches disappear.
//
// Plain C interface, loaded with ctypes. Every entry point launches on
// the caller's stream, does not synchronise, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// float32(3.4e38), the reference's BIG fill for a masked cell
__device__ __forceinline__ float big_f() { return __int_as_float(0x7f7fc99e); }

__device__ __forceinline__ float nan_max(float a, float b) {
    if (a != a) return a;
    if (b != b) return b;
    return fmaxf(a, b);
}

// One warp per scenario. Lane l walks cells l, l + 32, ... of the
// row-major [R, P] matrix and keeps its first minimum (strict <), then a
// shuffle reduction picks the smaller value and, on a tie, the smaller
// flat index: the first global minimum.
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
        const float ft = __fadd_rn(nan_max(nan_max(a[c], f[p]), nw), e[c]);
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
    for (int off = 16; off > 0; off >>= 1) {
        const float ov = __shfl_down_sync(0xffffffffu, best, off);
        const int oi = __shfl_down_sync(0xffffffffu, bidx, off);
        if (ov < best || (ov == best && oi < bidx)) {
            best = ov;
            bidx = oi;
        }
    }
    if (lane == 0) {
        ft_min[s] = best;
        slot[s] = bidx / P;
        pe[s] = bidx % P;
        if (MASKED) feasible[s] = best < big_f() ? 1 : 0;
    }
}

// One thread per output (s, k, p): the running max over the MP
// predecessors of pfin + cost * cross, starting from -inf, then the max
// with the row's base.
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
    const int cl = pe_cluster[p];
    float m = __int_as_float(0xff800000);  // -inf
    for (int j = 0; j < MP; ++j) {
        const long long q = sk * MP + j;
        const float cross = pcl[q] != cl ? 1.0f : 0.0f;
        const float c = pv[q] ? __fadd_rn(pfin[q], __fmul_rn(cost[q], cross))
                              : __int_as_float(0xff800000);
        m = nan_max(m, c);
    }
    rows[i] = nan_max(m, bases[sk]);
}

constexpr int kSearchThreads = 128;  // 4 scenarios (warps) per block
constexpr int kRowThreads = 128;

}  // namespace

extern "C" int etf_ft_search_masked_launch(
        const float* avail, const float* free_t, const float* exec_t,
        const float* now, const uint8_t* slot_ok, const uint8_t* pe_alive,
        float* ft_min, int32_t* slot, int32_t* pe, uint8_t* feasible,
        int S, int R, int P, void* stream) {
    const int warps = kSearchThreads / 32;
    const int blocks = (S + warps - 1) / warps;
    etf_search_kernel<true><<<blocks, kSearchThreads, 0, (cudaStream_t)stream>>>(
        avail, free_t, exec_t, now, slot_ok, pe_alive, ft_min, slot, pe,
        feasible, S, R, P);
    return (int)cudaGetLastError();
}

extern "C" int etf_ft_search_launch(
        const float* avail, const float* free_t, const float* exec_t,
        const float* now, float* ft_min, int32_t* slot, int32_t* pe,
        int S, int R, int P, void* stream) {
    const int warps = kSearchThreads / 32;
    const int blocks = (S + warps - 1) / warps;
    etf_search_kernel<false><<<blocks, kSearchThreads, 0, (cudaStream_t)stream>>>(
        avail, free_t, exec_t, now, nullptr, nullptr, ft_min, slot, pe,
        nullptr, S, R, P);
    return (int)cudaGetLastError();
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
