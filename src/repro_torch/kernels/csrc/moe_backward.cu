// Backward of the token-choice MoE layer for Hopper (sm_90a), bound through
// a plain C interface and loaded with ctypes
// (repro_torch/kernels/moe_experts/kernel.py).  Four kernels, six launches
// a layer, in the order the layer's autograd Function
// (kernels/moe_experts/ops.py::MoEFFN) runs them:
//
//   1. combine backward: dys and dweights from dout (moe_combine_backward);
//   2. the down data gradient: dh = dy . W_d^T with the SwiGLU or GELU
//      backward in its epilogue, writing da and db (moe_data_grad, SwiGLU
//      or GELU epilogue);
//   3. every weight gradient of the layer in one launch: dW = A[seg]^T .
//      G[seg] per expert, and the shared expert's over its T rows
//      (moe_weight_grad);
//   4. the gate/up data gradient: dx = da . W_g^T + db . W_u^T
//      (moe_data_grad, plain epilogue, two operand pairs);
//   5. the gather's backward: the forward combine kernel of moe_experts.cu
//      with unit weights (each token's k routed rows summed in order in
//      fp32, one rounding, then the shared expert's row added);
//   6. route backward: the renormalisation's and the softmax's adjoints per
//      token, dx = dlogits . w^T and dw = x^T . dlogits in fp32 on the CUDA
//      cores (moe_route_backward).
//
// No Pallas kernel stands behind these: the JAX package differentiates its
// MoE layer (src/repro/models/moe.py::moe_ffn, _dispatch_ffn) through XLA.
// They are the backward of the port's forward kernels (moe_experts.cu), at
// the forward's roundings: each product's bf16 output, the activation, the
// SwiGLU product.
//
// Contract.  Deterministic: no floating-point atomics, every sum in a fixed
// order, so two launches are bitwise equal.  Fixed-shape: every grid is
// sized from shapes, never from the device-side offsets, so a launch is
// capturable.  A segment's rows are found through the device-side offsets
// by each block; rows outside [offsets[e], offsets[e + 1]) never enter
// expert e's weight gradient (they load as zeros), and a segment of no rows
// gives a zero gradient.
//
// Design.  The grouped products are mma.sync.m16n8k16 (bf16 operands, fp32
// accumulators) on 128 x 128 output tiles, 8 warps of 64 x 32, two blocks
// an SM, fed by 16-byte cp.async copies (rows padded by 16 bytes, so
// ldmatrix meets no bank conflict): the data gradient double-buffers 64 k
// a stage (74 KB), the weight gradient rings 3 stages of 32 rows (52 KB).
// Neither the depth nor the ring changes a result: every output is the
// same chain of k16 steps from k = 0.  The data gradient reads both operands
// k-contiguous (dy rows, and the weights (E, N, K) as they lie: W_d (E, F,
// D) for dh, W_g (E, D, F) for dx); the weight gradient reads both
// operands with the row index as k (ldmatrix.trans), one block an output
// tile walking its segment's rows in order (no split over blocks).  One
// block a work item, (expert, row tile, 128 columns) for the data
// gradient, expert by expert with the row tiles innermost, so neighbouring
// blocks share each weight tile in L2.
//
// Bound on the H100 (989 TFLOP/s dense bf16, 3.35 TB/s) at moonshot's
// training microstep (T = 8192 tokens, P = 49152 pairs, D = 2048, F =
// 1408, a shared expert of 2F): the down data gradient 377 GFLOP, the
// weight gradients 1133, the gate/up data gradient 755: ~2.3 TFLOP, 2.3 ms,
// bound by operations.  The combine backward moves ~0.44 GB (dout, ys, dys:
// 0.13 ms, bytes); the route backward does 4 T D E = 4.3 GFLOP of fp32 (64
// us at 67 TFLOP/s, operations).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kThreads = 256;        // 8 warps
constexpr int kBM = 128, kBN = 128;
constexpr int kDgBK = 64, kDgStages = 2;   // data gradient: 64 k a stage, double-buffered
constexpr int kWgBK = 32, kWgStages = 3;   // weight gradient: 32 rows a stage, 3 stages
constexpr int kLdK = kDgBK + 8;      // a k-contiguous tile row: 72 bf16 (144 bytes)
constexpr int kLdMN = kBM + 8;       // an m- or n-contiguous tile row: 136 bf16 (272 bytes)
constexpr int kMaxExperts = 256;
constexpr int kDgStage = 2 * kBM * kLdK * 2;       // data gradient: A and B tiles, bytes
constexpr int kWgStage = 2 * kWgBK * kLdMN * 2;    // weight gradient: A and B tiles, bytes
constexpr int kMaxJobs = 6;

enum Epi { kEpiSwiGLU = 0, kEpiGelu = 1, kEpiPlain = 2 };

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
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

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(addr)
                 : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(addr)
                 : "memory");
}

// c (16 x 8, fp32) += a (16 x 16, bf16, row) * b (16 x 8, bf16, col)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
    asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
                 "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
                 : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float round_bf16(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float2 load_bf2(const __nv_bfloat16* p) {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__device__ __forceinline__ void store_bf2(__nv_bfloat16* p, float lo, float hi) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(lo, hi);
}

// The warp's 4 x 4 fragments of 16 x 8 (64 x 32 a warp) times one k16 step:
// a from `af`, b from `bf`.
__device__ __forceinline__ void mma_tile(float (&acc)[4][4][4], const uint32_t (&af)[4][4],
                                         const uint32_t (&bf)[4][2]) {
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int nj = 0; nj < 4; ++nj) mma_bf16(acc[mi][nj], af[mi], bf[nj][0], bf[nj][1]);
}

// The experts' clamped offsets and first work items of one group, by warp
// 0 (lane l a run of experts, then a warp scan): expert e's rows [offs[e],
// offs[e + 1]), its items from first[e]; first[n_exp] the group's count.
// Null offsets: one segment of all rows.
__device__ void scan_items(const int* offsets, int rows, int n_exp, int nc, int* offs,
                           int* first) {
    const int lane = threadIdx.x & 31;
    auto clamp = [&](int e) {
        if (offsets == nullptr) return e == 0 ? 0 : rows;
        return min(max(__ldg(offsets + e), 0), rows);
    };
    auto items = [&](int lo, int hi) { return (max(hi - lo, 0) + kBM - 1) / kBM * nc; };
    const int per = (n_exp + 31) / 32;
    const int e0 = min(n_exp, lane * per), e1 = min(n_exp, e0 + per);
    int sum = 0;
    for (int e = e0; e < e1; ++e) {
        offs[e] = clamp(e);
        sum += items(offs[e], clamp(e + 1));
    }
    int incl = sum;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
        const int v = __shfl_up_sync(0xffffffffu, incl, d);
        if (lane >= d) incl += v;
    }
    int run = incl - sum;
    for (int e = e0; e < e1; ++e) {
        first[e] = run;
        run += items(offs[e], clamp(e + 1));
    }
    if (lane == 31) {
        offs[n_exp] = clamp(n_exp);
        first[n_exp] = incl;
    }
}

// -- the grouped data gradient ------------------------------------------------------

struct DGroup {
    const __nv_bfloat16* g0;     // (rows, K): the first A operand (dy, or da)
    const __nv_bfloat16* g1;     // (rows, K) or null: a second A operand (db), with w1
    const __nv_bfloat16* w0;     // (n_exp, N, K): the B operand transposed, as the weight lies
    const __nv_bfloat16* w1;
    const int* offsets;          // (n_exp + 1,) on the device, or null: one segment of `rows`
    const __nv_bfloat16* pre_a;  // (rows, N): the forward's gate (SwiGLU) or up (GELU) rows
    const __nv_bfloat16* pre_b;  // (rows, N): the forward's up rows (SwiGLU)
    __nv_bfloat16* out0;         // (rows, N): da, or dx
    __nv_bfloat16* out1;         // (rows, N): db (SwiGLU)
    int rows, n_exp, N, K;
};

struct DParams {
    DGroup g[2];
};

// Stage s of an item: the s-th 64-wide slice of K, over the first operand
// pair for s < nk and the second after it; rows at or past r1, columns at
// or past N and k at or past K load as zeros.
__device__ __forceinline__ void dgrad_stage(unsigned char* st, const DGroup& g, int e, int r0,
                                            int r1, int n0, int s, int nk) {
    const bool second = s >= nk;
    const int k0 = (second ? s - nk : s) * kDgBK;
    const __nv_bfloat16* A = second ? g.g1 : g.g0;
    const __nv_bfloat16* B = (second ? g.w1 : g.w0) + (int64_t)e * g.N * g.K;
    __nv_bfloat16* sa = reinterpret_cast<__nv_bfloat16*>(st);
    __nv_bfloat16* sb = sa + kBM * kLdK;
    constexpr int kChunks = kDgBK / 8;         // 16-byte chunks of a tile row
#pragma unroll
    for (int q = threadIdx.x; q < kBM * kChunks; q += kThreads) {
        const int r = q / kChunks, ch = (q % kChunks) * 8;
        const int row = r0 + r, k = k0 + ch, n = n0 + r;
        const bool oka = row < r1 && k < g.K, okb = n < g.N && k < g.K;
        cp_async16(smem_u32(sa + r * kLdK + ch), A + (oka ? (int64_t)row * g.K + k : 0), oka);
        cp_async16(smem_u32(sb + r * kLdK + ch), B + (okb ? (int64_t)n * g.K + k : 0), okb);
    }
}

// gelu_tanh'(x), as PyTorch's GELU backward (tanh approximation) computes it
__device__ __forceinline__ float gelu_tanh_grad(float x) {
    const float kBeta = 0.7978845608028654f;     // sqrt(2 / pi)
    const float kKappa = 0.044715f;
    const float x_sq = x * x;
    const float inner = kBeta * (x + kKappa * x_sq * x);
    const float th = tanhf(inner);
    const float left = 0.5f * x, right = 1.f + th;
    return 0.5f * right + left * (1.f - th * th) * kBeta * (1.f + 3.f * kKappa * x_sq);
}

// One block a work item: group 0's experts in order, each its column tiles
// with the row tiles innermost, then group 1's the same way (the forward's
// item map).  The epilogue rounds dh = bf16(acc) as the forward rounds each
// product, then
//   SwiGLU: da = bf16(bf16(dh b) silu'(a)), db = bf16(dh bf16(silu(a)));
//   GELU:   da = bf16(dh gelu_tanh'(a));
//   plain:  out = bf16(acc).
template <int EPI>
__global__ void __launch_bounds__(kThreads, 2)
moe_data_grad_kernel(const __grid_constant__ DParams p) {
    extern __shared__ __align__(16) unsigned char smem[];
    __shared__ int offs[kMaxExperts + 1], first[kMaxExperts + 1];
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const DGroup& g0 = p.g[0];
    if (warp == 0) scan_items(g0.offsets, g0.rows, g0.n_exp, (g0.N + kBN - 1) / kBN, offs, first);
    __syncthreads();

    int i = blockIdx.x, e = 0, lo, hi;
    const bool in0 = i < first[g0.n_exp];
    if (in0) {
        int a = 0, b = g0.n_exp - 1;     // the last expert whose first item is at most i
        while (a < b) {
            const int m = (a + b + 1) >> 1;
            if (first[m] <= i) a = m;
            else b = m - 1;
        }
        e = a;
        lo = offs[e];
        hi = offs[e + 1];
        i -= first[e];
    } else {
        i -= first[g0.n_exp];
        const DGroup& g1 = p.g[1];
        if (i >= (g1.rows + kBM - 1) / kBM * ((g1.N + kBN - 1) / kBN)) return;
        lo = 0;
        hi = g1.rows;
    }
    const DGroup& g = in0 ? p.g[0] : p.g[1];
    const int rt = (hi - lo + kBM - 1) / kBM, c = i / rt;
    const int r0 = lo + (i - c * rt) * kBM, r1 = min(r0 + kBM, hi), n0 = c * kBN;
    const int nk = (g.K + kDgBK - 1) / kDgBK, steps = g.g1 != nullptr ? 2 * nk : nk;

    float acc[4][4][4];
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int nj = 0; nj < 4; ++nj)
#pragma unroll
            for (int q = 0; q < 4; ++q) acc[mi][nj][q] = 0.f;

#pragma unroll
    for (int s = 0; s < kDgStages - 1; ++s) {
        if (s < steps) dgrad_stage(smem + s * kDgStage, g, e, r0, r1, n0, s, nk);
        cp_async_commit();
    }
    const int wm = warp >> 2, wn = warp & 3;
    for (int s = 0; s < steps; ++s) {
        cp_async_wait<kDgStages - 2>();
        __syncthreads();          // stage s landed; the slot refilled below is free
        const int ahead = s + kDgStages - 1;
        if (ahead < steps)
            dgrad_stage(smem + (ahead % kDgStages) * kDgStage, g, e, r0, r1, n0, ahead, nk);
        cp_async_commit();
        const __nv_bfloat16* sa =
            reinterpret_cast<const __nv_bfloat16*>(smem + (s % kDgStages) * kDgStage);
        const __nv_bfloat16* sb = sa + kBM * kLdK;
#pragma unroll
        for (int kk = 0; kk < kDgBK; kk += 16) {
            uint32_t af[4][4], bf[4][2];
#pragma unroll
            for (int mi = 0; mi < 4; ++mi) {
                const int m = wm * 64 + mi * 16 + (lane & 7) + 8 * ((lane >> 3) & 1);
                ldsm_x4(af[mi], smem_u32(sa + m * kLdK + kk + 8 * (lane >> 4)));
            }
#pragma unroll
            for (int nj = 0; nj < 4; nj += 2) {
                const int n = wn * 32 + nj * 8 + (lane & 7) + 8 * (lane >> 4);
                uint32_t r[4];
                ldsm_x4(r, smem_u32(sb + n * kLdK + kk + 8 * ((lane >> 3) & 1)));
                bf[nj][0] = r[0];
                bf[nj][1] = r[1];
                bf[nj + 1][0] = r[2];
                bf[nj + 1][1] = r[3];
            }
            mma_tile(acc, af, bf);
        }
    }

    // epilogue: fragment (mi, nj) holds rows 16 mi + lane / 4 (+ 8) and
    // columns 8 nj + 2 (lane % 4) (+ 1) of the warp's 64 x 32
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int nj = 0; nj < 4; ++nj)
#pragma unroll
            for (int half = 0; half < 2; ++half) {
                const int row = r0 + wm * 64 + mi * 16 + (lane >> 2) + 8 * half;
                const int col = n0 + wn * 32 + nj * 8 + 2 * (lane & 3);
                if (row >= r1 || col >= g.N) continue;      // N % 8 == 0: col + 1 < N too
                const int64_t o = (int64_t)row * g.N + col;
                const float v0 = acc[mi][nj][2 * half], v1 = acc[mi][nj][2 * half + 1];
                if (EPI == kEpiPlain) {
                    store_bf2(g.out0 + o, v0, v1);
                    continue;
                }
                const float2 a = load_bf2(g.pre_a + o);
                const float av[2] = {a.x, a.y}, dh[2] = {round_bf16(v0), round_bf16(v1)};
                float da[2], db[2] = {0.f, 0.f};
                if (EPI == kEpiSwiGLU) {
                    const float2 b = load_bf2(g.pre_b + o);
                    const float bv[2] = {b.x, b.y};
#pragma unroll
                    for (int q = 0; q < 2; ++q) {
                        const float sg = 1.f / (1.f + expf(-av[q]));
                        const float silu = round_bf16(av[q] / (1.f + expf(-av[q])));
                        const float dg = round_bf16(dh[q] * bv[q]);
                        da[q] = dg * (sg * (1.f + av[q] * (1.f - sg)));
                        db[q] = dh[q] * silu;
                    }
                    store_bf2(g.out1 + o, db[0], db[1]);
                } else {
#pragma unroll
                    for (int q = 0; q < 2; ++q) da[q] = dh[q] * gelu_tanh_grad(av[q]);
                }
                store_bf2(g.out0 + o, da[0], da[1]);
            }
}

// The grid: at most (rows0 / BM + n_exp0) column-tile rows of items for
// group 0 (each expert adds at most one partial row tile) and ceil(rows1 /
// BM) for group 1, one block an item; blocks past the real count exit.
int64_t dgrad_blocks(int rows0, int n_exp0, int N0, int rows1, int N1) {
    const int64_t nc0 = (N0 + kBN - 1) / kBN, nc1 = (N1 + kBN - 1) / kBN;
    return ((int64_t)rows0 / kBM + n_exp0) * nc0 +
           (rows1 > 0 ? ((int64_t)rows1 + kBM - 1) / kBM * nc1 : 0);
}

template <int EPI>
cudaError_t launch_dgrad(const DParams& p, int64_t blocks, cudaStream_t stream) {
    const int smem = kDgStages * kDgStage;
    cudaError_t err = cudaFuncSetAttribute(moe_data_grad_kernel<EPI>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    moe_data_grad_kernel<EPI><<<(unsigned)blocks, kThreads, smem, stream>>>(p);
    return cudaGetLastError();
}

// -- the grouped weight gradient ----------------------------------------------------

struct WJob {
    const __nv_bfloat16* a;      // (rows, M)
    const __nv_bfloat16* b;      // (rows, N)
    __nv_bfloat16* out;          // (n_exp, M, N): out[e] = a[seg e]^T b[seg e]
    const int* offsets;          // (n_exp + 1,) on the device, or null: one segment of `rows`
    int rows, n_exp, M, N;
    int first;                   // the job's first item
};

struct WParams {
    WJob job[kMaxJobs];
    int n_jobs;
};

// Rows [r, r + 32) of the segment (rows at or past hi load as zeros), M
// columns from m0 of a, N columns from n0 of b.
__device__ __forceinline__ void wgrad_stage(unsigned char* st, const WJob& j, int r, int hi,
                                            int m0, int n0) {
    __nv_bfloat16* sa = reinterpret_cast<__nv_bfloat16*>(st);
    __nv_bfloat16* sb = sa + kWgBK * kLdMN;
#pragma unroll
    for (int q = threadIdx.x; q < kWgBK * (kBM / 8); q += kThreads) {
        const int rr = q >> 4, ch = (q & 15) * 8;
        const int row = r + rr, m = m0 + ch, n = n0 + ch;
        const bool oka = row < hi && m < j.M, okb = row < hi && n < j.N;
        cp_async16(smem_u32(sa + rr * kLdMN + ch), j.a + (oka ? (int64_t)row * j.M + m : 0), oka);
        cp_async16(smem_u32(sb + rr * kLdMN + ch), j.b + (okb ? (int64_t)row * j.N + n : 0), okb);
    }
}

// One block an output tile (job, expert, 128 rows of M, 128 columns of N),
// walking its segment's rows in order, 32 at a time, into fp32 registers;
// one bf16 rounding at the end.  Items: job by job (the caller puts the
// longest segments first), expert by expert, the N tiles innermost.
__global__ void __launch_bounds__(kThreads, 2)
moe_weight_grad_kernel(const __grid_constant__ WParams p) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    int jb = 0;
    for (int q = 1; q < p.n_jobs; ++q)
        if (p.job[q].first <= (int)blockIdx.x) jb = q;
    const WJob& j = p.job[jb];
    const int tm = (j.M + kBM - 1) / kBM, tn = (j.N + kBN - 1) / kBN;
    const int it = blockIdx.x - j.first;
    const int e = it / (tm * tn), rem = it - e * tm * tn;
    if (e >= j.n_exp) return;
    const int m0 = (rem / tn) * kBM, n0 = (rem % tn) * kBN;
    int lo = 0, hi = j.rows;
    if (j.offsets != nullptr) {
        lo = min(max(__ldg(j.offsets + e), 0), j.rows);
        hi = min(max(__ldg(j.offsets + e + 1), lo), j.rows);
    }
    const int steps = (hi - lo + kWgBK - 1) / kWgBK;

    float acc[4][4][4];
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int nj = 0; nj < 4; ++nj)
#pragma unroll
            for (int q = 0; q < 4; ++q) acc[mi][nj][q] = 0.f;

#pragma unroll
    for (int s = 0; s < kWgStages - 1; ++s) {
        if (s < steps) wgrad_stage(smem + s * kWgStage, j, lo + s * kWgBK, hi, m0, n0);
        cp_async_commit();
    }
    const int wm = warp >> 2, wn = warp & 3;
    for (int s = 0; s < steps; ++s) {
        cp_async_wait<kWgStages - 2>();
        __syncthreads();
        const int ahead = s + kWgStages - 1;
        if (ahead < steps)
            wgrad_stage(smem + (ahead % kWgStages) * kWgStage, j, lo + ahead * kWgBK, hi, m0, n0);
        cp_async_commit();
        const __nv_bfloat16* sa =
            reinterpret_cast<const __nv_bfloat16*>(smem + (s % kWgStages) * kWgStage);
        const __nv_bfloat16* sb = sa + kWgBK * kLdMN;
#pragma unroll
        for (int kk = 0; kk < kWgBK; kk += 16) {
            uint32_t af[4][4], bf[4][2];
#pragma unroll
            for (int mi = 0; mi < 4; ++mi) {
                // stored [k][m]: the transposed load gives the row-major A fragment
                const int m = wm * 64 + mi * 16 + 8 * ((lane >> 3) & 1);
                const int k = kk + (lane & 7) + 8 * (lane >> 4);
                ldsm_x4_trans(af[mi], smem_u32(sa + k * kLdMN + m));
            }
#pragma unroll
            for (int nj = 0; nj < 4; nj += 2) {
                const int n = wn * 32 + nj * 8 + 8 * (lane >> 4);
                const int k = kk + (lane & 7) + 8 * ((lane >> 3) & 1);
                uint32_t r[4];
                ldsm_x4_trans(r, smem_u32(sb + k * kLdMN + n));
                bf[nj][0] = r[0];
                bf[nj][1] = r[1];
                bf[nj + 1][0] = r[2];
                bf[nj + 1][1] = r[3];
            }
            mma_tile(acc, af, bf);
        }
    }

    __nv_bfloat16* out = j.out + (int64_t)e * j.M * j.N;
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int nj = 0; nj < 4; ++nj)
#pragma unroll
            for (int half = 0; half < 2; ++half) {
                const int row = m0 + wm * 64 + mi * 16 + (lane >> 2) + 8 * half;
                const int col = n0 + wn * 32 + nj * 8 + 2 * (lane & 3);
                if (row < j.M && col < j.N)
                    store_bf2(out + (int64_t)row * j.N + col, acc[mi][nj][2 * half],
                              acc[mi][nj][2 * half + 1]);
            }
}

// -- combine backward ---------------------------------------------------------------

// A warp a pair q = t k + j (sorted row pos[q]): dys[pos[q]] = kept ?
// bf16(dout[t] bf16(w[q])) : 0, one product and one rounding an element;
// dweights[q] = kept ? sum_d dout[t, d] ys[pos[q], d] : 0 in fp32, lane l
// summing the 8-column chunks l, l + 32, ... in order (each product of two
// bf16 values exact in fp32), then the lanes' sums by an xor butterfly
// (16, 8, 4, 2, 1): the order ref.py::moe_combine_backward_plain follows,
// so both outputs are bitwise their plain version.
__global__ void __launch_bounds__(kThreads)
moe_combine_backward_kernel(const __nv_bfloat16* __restrict__ dout,
                            const __nv_bfloat16* __restrict__ ys, const int* __restrict__ pos,
                            const float* __restrict__ weights,
                            const unsigned char* __restrict__ kept,
                            __nv_bfloat16* __restrict__ dys, float* __restrict__ dweights, int T,
                            int D, int k) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int64_t q = (int64_t)blockIdx.x * (kThreads / 32) + warp;
    if (q >= (int64_t)T * k) return;
    const int64_t t = q / k, row = __ldg(pos + q);
    const bool keep = kept == nullptr || __ldg(kept + q) != 0;
    const float wb = round_bf16(__ldg(weights + q));
    const uint4* g = reinterpret_cast<const uint4*>(dout + t * D);
    const uint4* y = reinterpret_cast<const uint4*>(ys + row * D);
    uint4* o = reinterpret_cast<uint4*>(dys + row * D);
    float acc = 0.f;
    for (int c = lane; c < D / 8; c += 32) {
        uint4 res = make_uint4(0u, 0u, 0u, 0u);
        if (keep) {
            const uint4 gv = __ldg(g + c), yv = __ldg(y + c);
            const __nv_bfloat16* gb = reinterpret_cast<const __nv_bfloat16*>(&gv);
            const __nv_bfloat16* yb = reinterpret_cast<const __nv_bfloat16*>(&yv);
            __nv_bfloat16* ob = reinterpret_cast<__nv_bfloat16*>(&res);
#pragma unroll
            for (int i = 0; i < 8; ++i) {
                const float gf = __bfloat162float(gb[i]);
                acc = __fadd_rn(acc, __fmul_rn(gf, __bfloat162float(yb[i])));
                ob[i] = __float2bfloat16_rn(__fmul_rn(gf, wb));
            }
        }
        o[c] = res;
    }
#pragma unroll
    for (int m = 16; m > 0; m >>= 1) acc = __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, m));
    if (lane == 0) dweights[q] = keep ? acc : 0.f;
}

// -- route backward -----------------------------------------------------------------

constexpr int kRbSub = 64;           // tokens a sub-tile
constexpr int kRbDs = 64;            // columns of D a block
constexpr int kRbMaxTiles = 16;      // token tiles, whose dw partials are summed in order
constexpr int kRbMaxE = 128, kRbMaxK = 32, kRbMaxD = 4096;
constexpr int kRbCounters = 256;     // ints of the counter buffer: one a column group

struct RbShape {
    int tile_subs, n_tiles, n_dg, smem;
    int64_t part_floats;
};

// Token tiles of whole 64-token sub-tiles, at most 16; column groups of 64.
RbShape rb_shape(int T, int D, int E) {
    RbShape s;
    const int n_sub = (T + kRbSub - 1) / kRbSub;
    const int tiles = min(kRbMaxTiles, n_sub);
    s.tile_subs = (n_sub + tiles - 1) / tiles;
    s.n_tiles = (n_sub + s.tile_subs - 1) / s.tile_subs;
    s.n_dg = (D + kRbDs - 1) / kRbDs;
    s.smem = (kRbDs * (E + 1) + kRbSub * (E + 1) + kRbSub * kRbDs) * 4;
    s.part_floats = s.n_tiles > 1 ? (int64_t)s.n_tiles * D * E : 0;
    return s;
}

struct RbParams {
    const __nv_bfloat16* x;      // (T, D)
    const float* w;              // (D, E)
    const float* gates;          // (T, E)
    const float* weights;        // (T, k)
    const int* idx;              // (T, k)
    const float* dweights;       // (T, k)
    const float* dgates;         // (T, E) or null
    __nv_bfloat16* dx;           // (T, D)
    float* dw;                   // (D, E)
    float* part;                 // (n_tiles, D, E) when n_tiles > 1
    int* counters;               // (kRbCounters,), zero between launches
    int T, D, E, k;
    RbShape s;
};

// dlogits of token t into row (E floats), one warp: the renormalisation's
// adjoint (weights = v / max(sum_j v_j, 1e-9), v the k chosen gates, the
// sums in order j), dv_j = (dw_j - [s >= 1e-9] sum_i dw_i w_i) / max(s,
// 1e-9); dgates plus dv scattered to the chosen experts in order j; then
// the softmax's adjoint g (dg - sum_e g dg).  A row past T is zero.
__device__ void token_dlogits(const RbParams& p, int t, float* row) {
    const int lane = threadIdx.x & 31, E = p.E, k = p.k;
    if (t >= p.T) {
        for (int e = lane; e < E; e += 32) row[e] = 0.f;
        return;
    }
    const int64_t tE = (int64_t)t * E, tk = (int64_t)t * k;
    const int ij = lane < k ? min(max(__ldg(p.idx + tk + lane), 0), E - 1) : 0;
    const float v = lane < k ? __ldg(p.gates + tE + ij) : 0.f;
    const float wj = lane < k ? __ldg(p.weights + tk + lane) : 0.f;
    const float dwj = lane < k ? __ldg(p.dweights + tk + lane) : 0.f;
    const float pw = __fmul_rn(dwj, wj);
    float s = 0.f, dot = 0.f;
    for (int j = 0; j < k; ++j) {
        const float vj = __shfl_sync(0xffffffffu, v, j), pj = __shfl_sync(0xffffffffu, pw, j);
        s = j == 0 ? vj : __fadd_rn(s, vj);
        dot = j == 0 ? pj : __fadd_rn(dot, pj);
    }
    const float den = s < 1e-9f ? 1e-9f : s;
    const float dv = __fdiv_rn(__fsub_rn(dwj, s >= 1e-9f ? dot : 0.f), den);
    float g[kRbMaxE / 32], dg[kRbMaxE / 32];
#pragma unroll
    for (int c = 0; c < kRbMaxE / 32; ++c) {
        const int e = lane + 32 * c;
        g[c] = e < E ? __ldg(p.gates + tE + e) : 0.f;
        if (e < E) row[e] = p.dgates != nullptr ? __ldg(p.dgates + tE + e) : 0.f;
    }
    __syncwarp();
    for (int j = 0; j < k; ++j) {
        const float dvj = __shfl_sync(0xffffffffu, dv, j);
        const int ej = __shfl_sync(0xffffffffu, ij, j);
        if (lane == 0) row[ej] = __fadd_rn(row[ej], dvj);
        __syncwarp();
    }
    float sum = 0.f;
#pragma unroll
    for (int c = 0; c < kRbMaxE / 32; ++c) {
        const int e = lane + 32 * c;
        dg[c] = e < E ? row[e] : 0.f;
        sum = fmaf(g[c], dg[c], sum);
    }
#pragma unroll
    for (int m = 16; m > 0; m >>= 1) sum = __fadd_rn(sum, __shfl_xor_sync(0xffffffffu, sum, m));
#pragma unroll
    for (int c = 0; c < kRbMaxE / 32; ++c) {
        const int e = lane + 32 * c;
        if (e < E) row[e] = g[c] * (dg[c] - sum);
    }
}

// True in every thread of the one block that arrives last at `counter`
// (of `n`), which also sets it back to 0 for the next launch.  Every
// block's global writes before the call are visible to that block after it.
__device__ bool last_to_arrive(int* counter, int n, int* flag) {
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) {
        const bool last = atomicAdd(counter, 1) == n - 1;
        if (last) atomicExch(counter, 0);
        *flag = last;
    }
    __syncthreads();
    if (!*flag) return false;
    __threadfence();
    return true;
}

// Grid (token tiles, column groups of 64).  A block takes its tile's tokens
// 64 at a time: their dlogits (a warp a token), dx for its 64 columns
// (fp32, e in order, one bf16 rounding), and its dw partial, each (d, e)
// an FMA chain over the tile's tokens in order in registers (warp w: d = 8
// w .. 8 w + 7; lane: e = lane + 32 c).  With one tile the partial is dw;
// otherwise the tiles' partials meet in the workspace and the last block of
// the column group adds them in tile order.
template <int CE>
__global__ void __launch_bounds__(kThreads) moe_route_backward_kernel(const RbParams p) {
    extern __shared__ float sm[];
    __shared__ int flag;
    const int E = p.E, ldE = E + 1;
    float* ws = sm;                          // (64 d, E + 1): w's rows d0 ..
    float* dl = ws + kRbDs * ldE;            // (64 tokens, E + 1): dlogits
    float* xs = dl + kRbSub * ldE;           // (64 tokens, 64 d): x in fp32
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int tile = blockIdx.x, d0 = blockIdx.y * kRbDs;
    const int nd = min(kRbDs, p.D - d0);
    for (int q = threadIdx.x; q < kRbDs * E; q += kThreads) {
        const int d = q / E, e = q - d * E;
        ws[d * ldE + e] = d < nd ? __ldg(p.w + (int64_t)(d0 + d) * E + e) : 0.f;
    }
    float acc[8][CE];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int c = 0; c < CE; ++c) acc[i][c] = 0.f;
    const int t_begin = tile * p.s.tile_subs * kRbSub;
    const int t_end = min(p.T, t_begin + p.s.tile_subs * kRbSub);
    for (int t0 = t_begin; t0 < t_end; t0 += kRbSub) {
        __syncthreads();                     // the previous sub-tile's dl and xs are read
        for (int q = threadIdx.x; q < kRbSub * kRbDs; q += kThreads) {
            const int r = q / kRbDs, d = q - r * kRbDs, t = t0 + r;
            xs[q] = t < p.T && d < nd ? __bfloat162float(p.x[(int64_t)t * p.D + d0 + d]) : 0.f;
        }
        for (int r = warp; r < kRbSub; r += kThreads / 32) token_dlogits(p, t0 + r, dl + r * ldE);
        __syncthreads();
        // dx: warp w tokens w + 8 i, lane columns lane and lane + 32
        float s0[8], s1[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) s0[i] = s1[i] = 0.f;
        for (int e = 0; e < E; ++e) {
            const float w0 = ws[lane * ldE + e], w1 = ws[(lane + 32) * ldE + e];
#pragma unroll
            for (int i = 0; i < 8; ++i) {
                const float gv = dl[(warp + 8 * i) * ldE + e];
                s0[i] = fmaf(gv, w0, s0[i]);
                s1[i] = fmaf(gv, w1, s1[i]);
            }
        }
#pragma unroll
        for (int i = 0; i < 8; ++i) {
            const int t = t0 + warp + 8 * i;
            if (t >= p.T) continue;
            __nv_bfloat16* dx = p.dx + (int64_t)t * p.D + d0;
            if (lane < nd) dx[lane] = __float2bfloat16_rn(s0[i]);
            if (lane + 32 < nd) dx[lane + 32] = __float2bfloat16_rn(s1[i]);
        }
        // dw partial: tokens in order (rows past T are zero)
        for (int r = 0; r < kRbSub; ++r) {
            float xv[8], gv[CE];
#pragma unroll
            for (int i = 0; i < 8; ++i) xv[i] = xs[r * kRbDs + 8 * warp + i];
#pragma unroll
            for (int c = 0; c < CE; ++c) {
                const int e = lane + 32 * c;
                gv[c] = e < E ? dl[r * ldE + e] : 0.f;
            }
#pragma unroll
            for (int i = 0; i < 8; ++i)
#pragma unroll
                for (int c = 0; c < CE; ++c) acc[i][c] = fmaf(xv[i], gv[c], acc[i][c]);
        }
    }
    float* dst = p.s.n_tiles > 1 ? p.part + (int64_t)tile * p.D * E : p.dw;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int c = 0; c < CE; ++c) {
            const int d = 8 * warp + i, e = lane + 32 * c;
            if (d < nd && e < E) dst[(int64_t)(d0 + d) * E + e] = acc[i][c];
        }
    if (p.s.n_tiles == 1) return;
    if (!last_to_arrive(p.counters + blockIdx.y, p.s.n_tiles, &flag)) return;
    for (int q = threadIdx.x; q < nd * E; q += kThreads) {
        const int64_t at = (int64_t)d0 * E + q;
        float sum = __ldcg(p.part + at);
        for (int tl = 1; tl < p.s.n_tiles; ++tl)
            sum = __fadd_rn(sum, __ldcg(p.part + (int64_t)tl * p.D * E + at));
        p.dw[at] = sum;
    }
}

template <int CE>
cudaError_t launch_route_backward(const RbParams& p, cudaStream_t stream) {
    cudaError_t err = cudaFuncSetAttribute(moe_route_backward_kernel<CE>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, p.s.smem);
    if (err != cudaSuccess) return err;
    moe_route_backward_kernel<CE><<<dim3(p.s.n_tiles, p.s.n_dg), kThreads, p.s.smem, stream>>>(p);
    return cudaGetLastError();
}

bool misaligned(const void* p) { return reinterpret_cast<uintptr_t>(p) & 15; }

}  // namespace

extern "C" {

// dys (P, D) bf16 in sorted order and dweights (T, k) fp32 from dout (T, D)
// bf16, ys (P, D) bf16, pos (T k,) int32, weights (T, k) fp32 and kept (T
// k,) bytes or null; P = T k, D a multiple of 8, the bf16 rows 16-byte
// aligned.  Returns a cudaError_t (cudaErrorInvalidValue for a shape the
// kernel does not take).
int moe_combine_backward_launch(const void* dout, const void* ys, const void* pos,
                                const void* weights, const void* kept, void* dys, void* dweights,
                                int T, int D, int k, void* stream) {
    if (T < 1 || D < 8 || D % 8 || k < 1 || misaligned(dout) || misaligned(ys) || misaligned(dys))
        return (int)cudaErrorInvalidValue;
    const int64_t blocks = ((int64_t)T * k + kThreads / 32 - 1) / (kThreads / 32);
    if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    moe_combine_backward_kernel<<<(unsigned)blocks, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(dout), static_cast<const __nv_bfloat16*>(ys),
        static_cast<const int*>(pos), static_cast<const float*>(weights),
        static_cast<const unsigned char*>(kept), static_cast<__nv_bfloat16*>(dys),
        static_cast<float*>(dweights), T, D, k);
    return (int)cudaGetLastError();
}

// One launch of the grouped data gradient.  epi (ref.py's MODES): 0
// SwiGLU backward (out0 = da, out1 = db, from pre_a = the forward's gate
// rows and pre_b its up rows), 1 GELU backward (out0 = da, pre_a the up
// rows), 2 plain (out0 = bf16 of the sum).  ptrs: 9 a group (g0, g1, w0, w1, offsets, pre_a,
// pre_b, out0, out1), dims: 4 a group (rows, n_exp, N, K); group 1 is
// absent when its rows are 0 and takes null offsets (one segment).  Each
// group's A operands are (rows, K), its weights (n_exp, N, K), its outputs
// (rows, N); all bf16, 16-byte aligned; N and K multiples of 8; g1 and w1
// (a second operand pair, summed into the same product) or neither.
int moe_data_grad_launch(int epi, const void* const* ptrs, const int* dims, void* stream) {
    if (epi < 0 || epi > 2 || ptrs == nullptr || dims == nullptr) return (int)cudaErrorInvalidValue;
    DParams p;
    memset(&p, 0, sizeof(p));
    for (int gi = 0; gi < 2; ++gi) {
        const void* const* q = ptrs + 9 * gi;
        const int* d = dims + 4 * gi;
        DGroup& g = p.g[gi];
        g.g0 = static_cast<const __nv_bfloat16*>(q[0]);
        g.g1 = static_cast<const __nv_bfloat16*>(q[1]);
        g.w0 = static_cast<const __nv_bfloat16*>(q[2]);
        g.w1 = static_cast<const __nv_bfloat16*>(q[3]);
        g.offsets = static_cast<const int*>(q[4]);
        g.pre_a = static_cast<const __nv_bfloat16*>(q[5]);
        g.pre_b = static_cast<const __nv_bfloat16*>(q[6]);
        g.out0 = static_cast<__nv_bfloat16*>(const_cast<void*>(q[7]));
        g.out1 = static_cast<__nv_bfloat16*>(const_cast<void*>(q[8]));
        g.rows = d[0];
        g.n_exp = d[1];
        g.N = d[2];
        g.K = d[3];
        if (gi == 1 && g.rows == 0) break;
        if (g.rows < 0 || g.n_exp < 1 || g.n_exp > kMaxExperts || g.N < 8 || g.N % 8 ||
            g.K < 8 || g.K % 8 || (gi == 0 && g.offsets == nullptr) ||
            (gi == 1 && (g.offsets != nullptr || g.n_exp != 1)))
            return (int)cudaErrorInvalidValue;
        if (g.g0 == nullptr || g.w0 == nullptr || g.out0 == nullptr ||
            (g.g1 == nullptr) != (g.w1 == nullptr) ||
            (epi != kEpiPlain && g.pre_a == nullptr) ||
            (epi == kEpiSwiGLU && (g.pre_b == nullptr || g.out1 == nullptr)))
            return (int)cudaErrorInvalidValue;
        for (int i = 0; i < 9; ++i)
            if (misaligned(q[i]) && i != 4) return (int)cudaErrorInvalidValue;
    }
    const int64_t blocks = dgrad_blocks(p.g[0].rows, p.g[0].n_exp, p.g[0].N, p.g[1].rows, p.g[1].N);
    if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
    if (blocks == 0) return 0;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (epi) {
        case kEpiSwiGLU: return (int)launch_dgrad<kEpiSwiGLU>(p, blocks, s);
        case kEpiGelu: return (int)launch_dgrad<kEpiGelu>(p, blocks, s);
        default: return (int)launch_dgrad<kEpiPlain>(p, blocks, s);
    }
}

// One launch of up to 6 weight gradients: job i is ptrs[4 i ..] = (a (rows,
// M), b (rows, N), out (n_exp, M, N), offsets (n_exp + 1,) int32 or null)
// and dims[4 i ..] = (rows, n_exp, M, N); out[e] = a[seg e]^T b[seg e],
// expert e's rows [offsets[e], offsets[e + 1]) (all rows without offsets,
// n_exp 1).  bf16, 16-byte aligned, M and N multiples of 8.
int moe_weight_grad_launch(const void* const* ptrs, const int* dims, int n_jobs, void* stream) {
    if (ptrs == nullptr || dims == nullptr || n_jobs < 1 || n_jobs > kMaxJobs)
        return (int)cudaErrorInvalidValue;
    WParams p;
    memset(&p, 0, sizeof(p));
    p.n_jobs = n_jobs;
    int64_t items = 0;
    for (int i = 0; i < n_jobs; ++i) {
        WJob& j = p.job[i];
        j.a = static_cast<const __nv_bfloat16*>(ptrs[4 * i]);
        j.b = static_cast<const __nv_bfloat16*>(ptrs[4 * i + 1]);
        j.out = static_cast<__nv_bfloat16*>(const_cast<void*>(ptrs[4 * i + 2]));
        j.offsets = static_cast<const int*>(ptrs[4 * i + 3]);
        j.rows = dims[4 * i];
        j.n_exp = dims[4 * i + 1];
        j.M = dims[4 * i + 2];
        j.N = dims[4 * i + 3];
        if (j.rows < 0 || j.n_exp < 1 || j.M < 8 || j.M % 8 || j.N < 8 || j.N % 8 ||
            (j.offsets == nullptr && j.n_exp != 1) || j.out == nullptr ||
            (j.rows > 0 && (j.a == nullptr || j.b == nullptr)) || misaligned(j.a) ||
            misaligned(j.b) || misaligned(j.out))
            return (int)cudaErrorInvalidValue;
        j.first = (int)items;
        items += (int64_t)j.n_exp * ((j.M + kBM - 1) / kBM) * ((j.N + kBN - 1) / kBN);
        if (items > 0x7fffffff) return (int)cudaErrorInvalidValue;
    }
    const int smem = kWgStages * kWgStage;
    cudaError_t err = cudaFuncSetAttribute(moe_weight_grad_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    moe_weight_grad_kernel<<<(unsigned)items, kThreads, smem, s>>>(p);
    return (int)cudaGetLastError();
}

// The route backward's shape for (T, D, E, k): out[0] token tiles, out[1]
// column groups, out[2] dynamic shared memory bytes, out[3] workspace bytes
// (clamped to 2^31 - 1).  T >= 1, D even and at most 4096, 1 <= k <= E <=
// 128, k <= 32.
int moe_route_backward_plan(int T, int D, int E, int k, int* out) {
    if (T < 1 || D < 2 || D % 2 || D > kRbMaxD || E < 1 || E > kRbMaxE || k < 1 || k > E ||
        k > kRbMaxK || out == nullptr)
        return (int)cudaErrorInvalidValue;
    const RbShape s = rb_shape(T, D, E);
    out[0] = s.n_tiles;
    out[1] = s.n_dg;
    out[2] = s.smem;
    out[3] = (int)(s.part_floats * 4 < 0x7fffffff ? s.part_floats * 4 : 0x7fffffff);
    return 0;
}

// One launch of the route backward (see moe_route_backward_kernel): x (T,
// D) bf16, w (D, E) fp32, gates (T, E) fp32, weights (T, k) fp32, idx (T,
// k) int32, dweights (T, k) fp32, dgates (T, E) fp32 or null -> dx (T, D)
// bf16, dw (D, E) fp32.  workspace holds moe_route_backward_plan's bytes
// (16-byte aligned); counters, kRbCounters int32 zeros on the device, are
// left zero by every launch that completes (launches sharing them must not
// overlap).
int moe_route_backward_launch(const void* x, const void* w, const void* gates,
                              const void* weights, const void* idx, const void* dweights,
                              const void* dgates, void* dx, void* dw, void* workspace,
                              void* counters, int T, int D, int E, int k, void* stream) {
    if (T < 1 || D < 2 || D % 2 || D > kRbMaxD || E < 1 || E > kRbMaxE || k < 1 || k > E ||
        k > kRbMaxK || counters == nullptr || misaligned(workspace))
        return (int)cudaErrorInvalidValue;
    RbParams p;
    p.s = rb_shape(T, D, E);
    if (p.s.n_dg > kRbCounters || (p.s.n_tiles > 1 && workspace == nullptr))
        return (int)cudaErrorInvalidValue;
    p.x = static_cast<const __nv_bfloat16*>(x);
    p.w = static_cast<const float*>(w);
    p.gates = static_cast<const float*>(gates);
    p.weights = static_cast<const float*>(weights);
    p.idx = static_cast<const int*>(idx);
    p.dweights = static_cast<const float*>(dweights);
    p.dgates = static_cast<const float*>(dgates);
    p.dx = static_cast<__nv_bfloat16*>(dx);
    p.dw = static_cast<float*>(dw);
    p.part = static_cast<float*>(workspace);
    p.counters = static_cast<int*>(counters);
    p.T = T;
    p.D = D;
    p.E = E;
    p.k = k;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (E <= 32) return (int)launch_route_backward<1>(p, st);
    if (E <= 64) return (int)launch_route_backward<2>(p, st);
    return (int)launch_route_backward<4>(p, st);
}

const char* moe_backward_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
