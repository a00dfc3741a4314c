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
// Bound on the H100 (80 GB HBM3, 3.35 TB/s): the bytes of the live K/V lanes,
// read once; the fp32 arithmetic (4 flops per lane, query row and head dim)
// is far below the memory time at every served shape.  At minicpm-2b's
// decode (B=8 slots, ~544 live tokens, 36 kv heads x 64, bf16) that is
// about 40 MB a layer, 12 us; at recurrentgemma-2b's (B=8, one kv head of
// 256, G=10, window 2048) about 17 MB, 5 us.  A block per (slot, kv head)
// fills the card at the first shape (288 blocks) but leaves it nearly empty
// at the second (8 blocks on 132 SMs), where the kernel is then bound by
// one block's latency, not by bandwidth.
//
// Design.  The TPU kernel's sequential page axis becomes a loop inside the
// block, since blocks run in no order and carry nothing between them.  The
// grid is (kv head, slot, split):
//
// * Split over pages.  The wrapper picks the split count from the shapes
//   alone (B x Hkv against the SM count, and max_pages; lengths live on the
//   device and are never read on the host).  One split at B x Hkv >= 132.
//   Each block computes its slot's live page range on the device: from the
//   window's first page (the first page holding a lane above q_pos - window,
//   placed by lane_base / pos_stride) to the last page holding a lane below
//   lengths[b]; the range is cut into n_split equal parts and a block walks
//   its own.  A split with no live lane yields (0, -1e30, 0).
// * Merge in the same launch.  With one split the block writes (acc, m, l)
//   straight out.  With more, each block writes its partial state to
//   scratch (cached by the wrapper per device and shape), and the last block
//   of a (slot, head) to finish, found by an atomic ticket that it resets to
//   0, merges: m = max of the splits' m, l and acc the sums rescaled by
//   exp(m_s - m).  An empty split's (0, -1e30, 0) drops out of that sum, and
//   a row whose splits are all empty comes out as (0, -1e30, 0).  The
//   splits are summed in a fixed order, so the result does not depend on
//   which block finishes last.
// * Loads.  The split's lanes are visited 32 at a time (a tile may span
//   pages of any size).  K and V of a tile are copied into shared memory in
//   the pool's dtype by 16-byte cp.async, two stages deep, so the next
//   tile's copy is in flight while this one is scored; a lane that is not
//   live (unmapped page, past the length, outside the window) is
//   zero-filled and never read from the pool.
// * Scores.  Warp w owns query rows g = w, w + 4, ...: lane t scores row g
//   against tile lane t, reading its K row as 16-byte vectors (rows padded
//   by 16 bytes: no bank conflict), q pre-scaled in fp32 and broadcast.  The
//   warp reduces the running max and the normalizer with shuffles; masked
//   lanes get p = 0 after the max update, so a scrambled table leaks no
//   phantom weight while the running max is still -1e30.
// * P.V.  Thread (row set r, column pair c) owns columns 2c, 2c + 1 of rows
//   g = r, r + 128 / (D / 2), ...; it reads each V pair once for up to four
//   of its rows and rescales the accumulator by the row's alpha as it goes.
//
// Levers left: at D = 64, G = 1 one warp scores and sums a tile while the
// others only copy (a split of the tile's lanes across warps with a merge
// in shared memory would use all four); the bf16 tensor cores are not used
// (the kernel is bound by bytes); the split count is fixed by shape, so a
// short context at a small B x Hkv pays for a merge it does not need.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 128;              // 4 warps
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;                  // pool lanes per tile: one per warp lane

__device__ __forceinline__ float warp_max(float x) {
    for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
    return x;
}

__device__ __forceinline__ float warp_sum(float x) {
    for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
    return x;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; with valid false the 16 bytes are zero-filled
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
                 "r"(valid ? 16 : 0)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// 16 bytes of shared memory as floats
__device__ __forceinline__ void unpack16(const unsigned char* p, float* out, float) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    out[0] = x.x;
    out[1] = x.y;
    out[2] = x.z;
    out[3] = x.w;
}

__device__ __forceinline__ void unpack16(const unsigned char* p, float* out, __nv_bfloat16) {
    const uint4 x = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
        out[2 * i] = f.x;
        out[2 * i + 1] = f.y;
    }
}

__device__ __forceinline__ float2 load_pair(const unsigned char* p, float) {
    return *reinterpret_cast<const float2*>(p);
}

__device__ __forceinline__ float2 load_pair(const unsigned char* p, __nv_bfloat16) {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

// The first logical page holding a lane inside the window (position
// >= q_pos - window + 1); page j's last lane sits at
// j * pos_stride + lane_base + page_size - 1.
__device__ __forceinline__ int window_first_page(int qp, int window, int lane_base,
                                                 int pos_stride, int page_size) {
    const int num = qp - window + 2 - lane_base - page_size;
    return num <= 0 ? 0 : (num + pos_stride - 1) / pos_stride;
}

// floats of the partial state of one (row, split) in scratch: acc, then m
// and l, padded to a multiple of 4 so every acc starts 16-byte aligned
__host__ __device__ constexpr int partial_floats(int G, int D) {
    return G * D + 4 * ((2 * G + 3) / 4);
}

__host__ __device__ constexpr size_t smem_bytes(int G, int D, int elt, int n_split) {
    // K, V x 2 stages of kTile padded rows, then qs + acc (G*D each),
    // p (G*kTile), alpha + m + l (G each), merge weights (n_split*G)
    return (size_t)4 * kTile * (D * elt + 16) +
           sizeof(float) * ((size_t)2 * G * D + (size_t)G * kTile + 3 * (size_t)G +
                            (n_split > 1 ? (size_t)n_split * G : 0));
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) paged_attn_kernel(
    const T* __restrict__ q, const T* __restrict__ kp, const T* __restrict__ vp,
    const int* __restrict__ page_table, const int* __restrict__ lengths,
    const int* __restrict__ q_pos, int lane_base, int pos_stride, int has_window,
    int window, int Hkv, int G, int page_size, int max_pages, float scale, int n_split,
    float* __restrict__ acc_out, float* __restrict__ m_out, float* __restrict__ l_out,
    float* __restrict__ part, int* __restrict__ tickets) {
    constexpr int RB = D * (int)sizeof(T) + 16;    // padded K/V row, bytes
    constexpr int C = D * (int)sizeof(T) / 16;     // 16-byte chunks per row
    constexpr int EV = 16 / (int)sizeof(T);        // elements per chunk
    constexpr int NDP = D / 2;                     // column pairs
    constexpr int RS = kThreads / NDP;             // row sets in the P.V pass
    extern __shared__ __align__(16) unsigned char smem[];
    unsigned char* kv = smem;                      // [stage][K, V][kTile][RB]
    float* qs = reinterpret_cast<float*>(smem + 4 * kTile * RB);   // (G, D), pre-scaled
    float* acc = qs + G * D;                       // (G, D) running accumulator
    float* pr = acc + G * D;                       // (G, kTile) probabilities of a tile
    float* alpha = pr + G * kTile;                 // (G,) rescale of this tile
    float* m = alpha + G;                          // (G,) running max
    float* l = m + G;                              // (G,) running normalizer
    float* wts = l + G;                            // (n_split, G) merge weights
    __shared__ int is_last;

    const int h = blockIdx.x, b = blockIdx.y, split = blockIdx.z, tid = threadIdx.x;
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

    // this split's share of the slot's live pages [p_lo, p_hi)
    const int len = lengths[b];
    const int qp = q_pos[b];
    int p_hi = len > lane_base ? (len - lane_base + pos_stride - 1) / pos_stride : 0;
    p_hi = min(p_hi, max_pages);
    const int p_lo =
        has_window ? min(window_first_page(qp, window, lane_base, pos_stride, page_size), p_hi)
                   : 0;
    const int chunk = (p_hi - p_lo + n_split - 1) / n_split;
    const int s_lo = min(p_hi, p_lo + split * chunk), s_hi = min(p_hi, s_lo + chunk);
    const int lane_lo = s_lo * page_size, lane_hi = s_hi * page_size;
    const int* pt = page_table + (int64_t)b * max_pages;

    // is lane L (flat over the slot's pages) live; its pool page in pid
    auto live_lane = [&](int L, int& pid) {
        const int j = L / page_size, t = L - j * page_size;
        pid = pt[j];
        const int pos = j * pos_stride + lane_base + t;
        return pid >= 0 && pos < len && (!has_window || pos > qp - window);
    };
    auto stage = [&](int st, int L0) {
        unsigned char* ks = kv + (size_t)(2 * st) * kTile * RB;
        unsigned char* vs = ks + (size_t)kTile * RB;
        for (int i = tid; i < kTile * C; i += kThreads) {
            const int r = i / C, c = i - r * C;
            const int L = L0 + r;
            int pid = 0;
            const bool ok = L < lane_hi && live_lane(L, pid);
            const int64_t off =
                ok ? (((int64_t)pid * page_size + L % page_size) * Hkv + h) * D + c * EV : 0;
            cp_async16(smem_addr(ks + r * RB + c * 16), kp + off, ok);
            cp_async16(smem_addr(vs + r * RB + c * 16), vp + off, ok);
        }
    };

    const int n_tiles = (lane_hi - lane_lo + kTile - 1) / kTile;
    if (n_tiles > 0) stage(0, lane_lo);
    cp_async_commit();
    __syncthreads();

    const int dp = tid % NDP, rs = tid / NDP;
    for (int it = 0; it < n_tiles; ++it) {
        const int st = it & 1, L0 = lane_lo + it * kTile;
        if (it + 1 < n_tiles) stage(st ^ 1, L0 + kTile);
        cp_async_commit();
        cp_async_wait<1>();
        __syncthreads();
        const unsigned char* ks = kv + (size_t)(2 * st) * kTile * RB;
        const unsigned char* vs = ks + (size_t)kTile * RB;

        // lane t of every warp scores tile lane t
        int pid;
        const bool live = L0 + lane < lane_hi && live_lane(L0 + lane, pid);
        for (int g = warp; g < G; g += kWarps) {
            float s = kNegInf;
            if (live) {
                const float* qg = qs + g * D;
                const unsigned char* kr = ks + lane * RB;
                s = 0.f;
#pragma unroll
                for (int c = 0; c < C; ++c) {
                    float kf[EV];
                    unpack16(kr + c * 16, kf, T());
#pragma unroll
                    for (int e = 0; e < EV; ++e) s = fmaf(qg[c * EV + e], kf[e], s);
                }
            }
            // every lane reads m[g] before the shuffles; lane 0 writes it after
            const float m_prev = m[g];
            const float m_new = fmaxf(m_prev, warp_max(s));
            const float a = expf(m_prev - m_new);
            const float p = live ? expf(s - m_new) : 0.f;
            pr[g * kTile + lane] = p;
            const float psum = warp_sum(p);
            if (lane == 0) {
                l[g] = l[g] * a + psum;
                m[g] = m_new;
                alpha[g] = a;
            }
        }
        __syncthreads();

        // acc = acc * alpha + p.V, four rows per pass over the tile's V
        const int nt = min(kTile, lane_hi - L0);
        const unsigned char* vcol = vs + dp * 2 * (int)sizeof(T);
        for (int g0 = rs; g0 < G; g0 += 4 * RS) {
            float2 a[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                const int g = g0 + i * RS;
                a[i] = make_float2(0.f, 0.f);
                if (g < G) {
                    const float2 x = *reinterpret_cast<const float2*>(acc + g * D + 2 * dp);
                    a[i] = make_float2(x.x * alpha[g], x.y * alpha[g]);
                }
            }
            for (int t = 0; t < nt; ++t) {
                const float2 vv = load_pair(vcol + t * RB, T());
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                    const int g = g0 + i * RS;
                    if (g < G) {
                        const float p = pr[g * kTile + t];
                        a[i].x = fmaf(p, vv.x, a[i].x);
                        a[i].y = fmaf(p, vv.y, a[i].y);
                    }
                }
            }
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                const int g = g0 + i * RS;
                if (g < G) *reinterpret_cast<float2*>(acc + g * D + 2 * dp) = a[i];
            }
        }
        __syncthreads();
    }
    cp_async_wait<0>();

    if (n_split == 1) {
        for (int i = tid; i < G * D; i += kThreads) acc_out[row * G * D + i] = acc[i];
        for (int g = tid; g < G; g += kThreads) {
            m_out[row * G + g] = m[g];
            l_out[row * G + g] = l[g];
        }
        return;
    }

    // several splits: publish this one's state; the last block of the row merges
    const int PS = partial_floats(G, D);
    float* mine = part + (row * n_split + split) * PS;
    for (int i = tid; i < G * D; i += kThreads) mine[i] = acc[i];
    for (int g = tid; g < G; g += kThreads) {
        mine[G * D + g] = m[g];
        mine[G * D + G + g] = l[g];
    }
    __threadfence();
    __syncthreads();
    if (tid == 0) is_last = atomicAdd(tickets + row, 1) == n_split - 1;
    __syncthreads();
    if (!is_last) return;
    __threadfence();

    const float* rp = part + row * n_split * PS;
    for (int g = tid; g < G; g += kThreads) {
        float mx = kNegInf;
        for (int s = 0; s < n_split; ++s) mx = fmaxf(mx, __ldcg(rp + s * PS + G * D + g));
        float sum = 0.f;
        for (int s = 0; s < n_split; ++s) {
            const float w = expf(__ldcg(rp + s * PS + G * D + g) - mx);
            wts[s * G + g] = w;
            sum += __ldcg(rp + s * PS + G * D + G + g) * w;
        }
        m_out[row * G + g] = mx;
        l_out[row * G + g] = sum;
    }
    __syncthreads();
    float4* out4 = reinterpret_cast<float4*>(acc_out + row * G * D);
    for (int i = tid; i < G * D / 4; i += kThreads) {
        const int g = 4 * i / D;
        float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
        for (int s = 0; s < n_split; ++s) {
            const float4 x = __ldcg(reinterpret_cast<const float4*>(rp + s * PS) + i);
            const float w = wts[s * G + g];
            a.x = fmaf(w, x.x, a.x);
            a.y = fmaf(w, x.y, a.y);
            a.z = fmaf(w, x.z, a.z);
            a.w = fmaf(w, x.w, a.w);
        }
        out4[i] = a;
    }
    if (tid == 0) tickets[row] = 0;          // ready for the next launch
}

template <typename T, int D>
cudaError_t launch_typed(const void* q, const void* kp, const void* vp, const int* page_table,
                         const int* lengths, const int* q_pos, int lane_base, int pos_stride,
                         int has_window, int window, int B, int Hkv, int G, int page_size,
                         int max_pages, int n_split, float* acc, float* m, float* l,
                         float* part, int* tickets, cudaStream_t stream) {
    const size_t smem = smem_bytes(G, D, (int)sizeof(T), n_split);
    auto kern = paged_attn_kernel<T, D>;
    if (smem > 48 * 1024) {
        cudaError_t err = cudaFuncSetAttribute(
            kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return err;
    }
    const float scale = 1.0f / sqrtf((float)D);
    kern<<<dim3(Hkv, B, n_split), kThreads, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(kp), static_cast<const T*>(vp),
        page_table, lengths, q_pos, lane_base, pos_stride, has_window, window, Hkv, G,
        page_size, max_pages, scale, n_split, acc, m, l, part, tickets);
    return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dim(int D, const void* q, const void* kp, const void* vp,
                       const int* page_table, const int* lengths, const int* q_pos,
                       int lane_base, int pos_stride, int has_window, int window, int B,
                       int Hkv, int G, int page_size, int max_pages, int n_split, float* acc,
                       float* m, float* l, float* part, int* tickets, cudaStream_t stream) {
#define PA_CASE(DD)                                                                      \
    case DD:                                                                             \
        return launch_typed<T, DD>(q, kp, vp, page_table, lengths, q_pos, lane_base,     \
                                   pos_stride, has_window, window, B, Hkv, G, page_size, \
                                   max_pages, n_split, acc, m, l, part, tickets, stream);
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

// dtype: 0 = float32, 1 = bfloat16 (q, kp and vp share it).  n_split: page
// splits per (slot, kv head); above 1, part holds B * Hkv * n_split partial
// states of paged_attention_partial_floats(G, D) floats and tickets B * Hkv
// ints that are 0 before the launch (the kernel leaves them 0).  kp and vp
// must be 16-byte aligned.  Returns a cudaError_t: 0 on success,
// cudaErrorInvalidValue for a head dim, split count, alignment or
// shared-memory size the kernel does not take.
int paged_attention_launch(int dtype, int D, const void* q, const void* kp, const void* vp,
                           const int* page_table, const int* lengths, const int* q_pos,
                           int lane_base, int pos_stride, int has_window, int window, int B,
                           int Hkv, int G, int page_size, int max_pages, int n_split,
                           float* acc, float* m, float* l, float* part, int* tickets,
                           void* stream) {
    const int elt = dtype == 0 ? 4 : 2;
    if (n_split < 1 || n_split > 65535 || pos_stride < 1 || page_size < 1 ||
        (n_split > 1 && (part == nullptr || tickets == nullptr)) ||
        ((reinterpret_cast<uintptr_t>(kp) | reinterpret_cast<uintptr_t>(vp)) & 15) != 0 ||
        smem_bytes(G, D, elt, n_split) > 227 * 1024)
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype == 0)
        return (int)launch_dim<float>(D, q, kp, vp, page_table, lengths, q_pos, lane_base,
                                      pos_stride, has_window, window, B, Hkv, G, page_size,
                                      max_pages, n_split, acc, m, l, part, tickets, s);
    if (dtype == 1)
        return (int)launch_dim<__nv_bfloat16>(D, q, kp, vp, page_table, lengths, q_pos,
                                              lane_base, pos_stride, has_window, window, B,
                                              Hkv, G, page_size, max_pages, n_split, acc, m,
                                              l, part, tickets, s);
    return (int)cudaErrorInvalidValue;
}

int paged_attention_partial_floats(int G, int D) { return partial_floats(G, D); }

const char* paged_attention_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
