// Paged-attention decode (S=1) for Hopper (sm_90a), bound through a plain C
// interface and loaded with ctypes (repro_torch/kernels/paged_attention/kernel.py).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/paged_attention/kernel.py::paged_attention_kernel
// (body _paged_attn_kernel).  Same contract: q (B, Hkv, G, D) against the shared
// pool kp/vp (n_pages, page_size, Hkv, D) through page_table (B, max_pages),
// -1 = unmapped.  Lane t of logical page j sits at position
// j * pos_stride + lane_base + t and is live iff its page is mapped, the
// position is below lengths[b] and, with a window, above q_pos[b] - window.
// Output is the unnormalized fp32 online-softmax state: acc (B, Hkv, G, D),
// m and l (B, Hkv, G).  A row with no live lane comes out as (0, -1e30, 0).
//
// Design: one block per (kv head, slot).  The TPU kernel's sequential page
// axis becomes a loop inside the block, since blocks run in no order and
// carry nothing between them.  The block reads its own page-table row and
// visits pages j < ceil((lengths[b] - lane_base) / pos_stride), skipping a -1
// page outright (all its lanes are masked, so the TPU kernel adds nothing for
// it either).  Each page is staged TILE lanes at a time in shared memory as
// fp32; warp w owns query rows g = w, w + 4, ...: lane t scores row g against
// pool lane t, the warp reduces the running max and the normalizer with
// shuffles, and masked lanes get p = 0 after the max update (so a scrambled
// table leaks no phantom weight while the running max is still -1e30).  Then
// every thread folds p·V into its own accumulator entries.
//
// Bound on the H100 (80 GB HBM3, 3.35 TB/s): the bytes of the live K/V lanes,
// read once.  At the serving shape of minicpm-2b (B=8 slots, ~544 live
// tokens, 36 kv heads x 64, bf16) that is about 40 MB per layer launch, about
// 12 us; the fp32 arithmetic (4 flops per lane and head dim) is ~70x below the
// memory time.  What this simple design leaves on the table: K/V are loaded
// with 2-byte scalar loads and no copy of the next tile is in flight while
// the current one is scored (cp.async / TMA double buffering); a slot's whole
// context runs in one block, so B x Hkv blocks (288 at the serving shape) are
// only ~2 waves on 132 SMs and a long context has no split over pages
// (split-K with a merge pass); with G = 1 only one warp scores a tile.
//
// recurrentgemma-2b's local-attention layers call it at D = 256, Hkv = 1,
// G = 10 with a 2048-token window: 87.5 KB of shared memory (the opt-in path
// above 48 KB) and a grid of Hkv x B = 8 blocks at 8 slots.  The page loop
// starts at page 0 and masks lanes outside the window, so past the window it
// reads pages that no lane attends.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 128;              // 4 warps
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;                  // pool lanes staged per pass: one per warp lane

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ float warp_max(float x) {
    for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
    return x;
}

__device__ __forceinline__ float warp_sum(float x) {
    for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
    return x;
}

__host__ __device__ constexpr size_t smem_floats(int G, int D) {
    // qs + acc (G*D each), ks (kTile*(D+1)), vs (kTile*D), p (G*kTile), m + l (G each)
    return (size_t)2 * G * D + (size_t)kTile * (D + 1) + (size_t)kTile * D
           + (size_t)G * kTile + 2 * (size_t)G;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) paged_attn_kernel(
    const T* __restrict__ q, const T* __restrict__ kp, const T* __restrict__ vp,
    const int* __restrict__ page_table, const int* __restrict__ lengths,
    const int* __restrict__ q_pos, int lane_base, int pos_stride, int has_window,
    int window, int Hkv, int G, int page_size, int max_pages, float scale,
    float* __restrict__ acc_out, float* __restrict__ m_out, float* __restrict__ l_out) {
    constexpr int KS = D + 1;              // padded K row: lanes t hit distinct banks
    extern __shared__ float smem[];
    float* qs = smem;                      // (G, D) query rows, pre-scaled
    float* acc = qs + G * D;               // (G, D) running accumulator
    float* ks = acc + G * D;               // (kTile, KS)
    float* vs = ks + kTile * KS;           // (kTile, D)
    float* pr = vs + kTile * D;            // (G, kTile) probabilities of this tile
    float* m = pr + G * kTile;             // (G,) running max
    float* l = m + G;                      // (G,) running normalizer

    const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
    const int warp = tid / 32, lane = tid % 32;
    const int64_t row = (int64_t)b * Hkv + h;
    const T* qrow = q + row * G * D;
    for (int i = tid; i < G * D; i += kThreads) {
        qs[i] = to_float(qrow[i]) * scale;
        acc[i] = 0.f;
    }
    for (int g = tid; g < G; g += kThreads) {
        m[g] = kNegInf;
        l[g] = 0.f;
    }

    const int len = lengths[b];
    const int qp = q_pos[b];
    int n_live = len > lane_base ? (len - lane_base + pos_stride - 1) / pos_stride : 0;
    if (n_live > max_pages) n_live = max_pages;
    const int* pt = page_table + (int64_t)b * max_pages;
    __syncthreads();

    for (int j = 0; j < n_live; ++j) {
        const int pid = pt[j];
        if (pid < 0) continue;             // uniform over the block
        for (int t0 = 0; t0 < page_size; t0 += kTile) {
            const int nt = min(kTile, page_size - t0);
            for (int i = tid; i < nt * D; i += kThreads) {
                const int t = i / D, d = i % D;
                const int64_t off = (((int64_t)pid * page_size + t0 + t) * Hkv + h) * D + d;
                ks[t * KS + d] = to_float(kp[off]);
                vs[t * D + d] = to_float(vp[off]);
            }
            __syncthreads();

            // lane t of every warp scores pool lane t0 + t
            const int pos = j * pos_stride + lane_base + t0 + lane;
            const bool live = lane < nt && pos < len && (!has_window || pos > qp - window);
            for (int g = warp; g < G; g += kWarps) {
                float s = kNegInf;
                if (live) {
                    s = 0.f;
                    const float* qg = qs + g * D;
                    const float* kt = ks + lane * KS;
#pragma unroll
                    for (int d = 0; d < D; ++d) s = fmaf(qg[d], kt[d], s);
                }
                // every lane reads m[g] before the shuffles; lane 0 writes it after
                const float m_prev = m[g];
                const float m_new = fmaxf(m_prev, warp_max(s));
                const float alpha = expf(m_prev - m_new);
                const float p = live ? expf(s - m_new) : 0.f;
                pr[g * kTile + lane] = p;
                const float psum = warp_sum(p);
                if (lane == 0) {
                    l[g] = l[g] * alpha + psum;
                    m[g] = m_new;
                }
                // the warp owns row g: rescale it now, the pass below adds p·V
                for (int d = lane; d < D; d += 32) acc[g * D + d] *= alpha;
            }
            __syncthreads();

            for (int i = tid; i < G * D; i += kThreads) {
                const int g = i / D, d = i % D;
                float s = acc[i];
                const float* pg = pr + g * kTile;
                for (int t = 0; t < nt; ++t) s = fmaf(pg[t], vs[t * D + d], s);
                acc[i] = s;
            }
            __syncthreads();
        }
    }

    for (int i = tid; i < G * D; i += kThreads) acc_out[row * G * D + i] = acc[i];
    for (int g = tid; g < G; g += kThreads) {
        m_out[row * G + g] = m[g];
        l_out[row * G + g] = l[g];
    }
}

template <typename T, int D>
cudaError_t launch_typed(const void* q, const void* kp, const void* vp, const int* page_table,
                         const int* lengths, const int* q_pos, int lane_base, int pos_stride,
                         int has_window, int window, int B, int Hkv, int G, int page_size,
                         int max_pages, float* acc, float* m, float* l, cudaStream_t stream) {
    const size_t smem = smem_floats(G, D) * sizeof(float);
    auto kern = paged_attn_kernel<T, D>;
    if (smem > 48 * 1024) {
        cudaError_t err = cudaFuncSetAttribute(
            kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return err;
    }
    const float scale = 1.0f / sqrtf((float)D);
    kern<<<dim3(Hkv, B), kThreads, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(kp), static_cast<const T*>(vp),
        page_table, lengths, q_pos, lane_base, pos_stride, has_window, window, Hkv, G,
        page_size, max_pages, scale, acc, m, l);
    return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dim(int D, const void* q, const void* kp, const void* vp,
                       const int* page_table, const int* lengths, const int* q_pos,
                       int lane_base, int pos_stride, int has_window, int window, int B,
                       int Hkv, int G, int page_size, int max_pages, float* acc, float* m,
                       float* l, cudaStream_t stream) {
#define PA_CASE(DD)                                                                      \
    case DD:                                                                             \
        return launch_typed<T, DD>(q, kp, vp, page_table, lengths, q_pos, lane_base,     \
                                   pos_stride, has_window, window, B, Hkv, G, page_size, \
                                   max_pages, acc, m, l, stream);
    switch (D) {
        PA_CASE(8)
        PA_CASE(16)
        PA_CASE(32)
        PA_CASE(64)
        PA_CASE(128)
        PA_CASE(256)
        default:
            return cudaErrorInvalidValue;
    }
#undef PA_CASE
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, kp and vp share it).  Returns a
// cudaError_t: 0 on success, cudaErrorInvalidValue for a head dim or a
// shared-memory size the kernel does not take.
int paged_attention_launch(int dtype, int D, const void* q, const void* kp, const void* vp,
                           const int* page_table, const int* lengths, const int* q_pos,
                           int lane_base, int pos_stride, int has_window, int window, int B,
                           int Hkv, int G, int page_size, int max_pages, float* acc, float* m,
                           float* l, void* stream) {
    if (smem_floats(G, D) * sizeof(float) > 227 * 1024) return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype == 0)
        return (int)launch_dim<float>(D, q, kp, vp, page_table, lengths, q_pos, lane_base,
                                      pos_stride, has_window, window, B, Hkv, G, page_size,
                                      max_pages, acc, m, l, s);
    if (dtype == 1)
        return (int)launch_dim<__nv_bfloat16>(D, q, kp, vp, page_table, lengths, q_pos,
                                              lane_base, pos_stride, has_window, window, B,
                                              Hkv, G, page_size, max_pages, acc, m, l, s);
    return (int)cudaErrorInvalidValue;
}

const char* paged_attention_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
