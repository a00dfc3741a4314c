// Causal / sliding-window flash attention (streaming softmax) for Hopper
// (sm_90a), bound through a plain C interface and loaded with ctypes
// (repro_torch/kernels/flash_attention/kernel.py).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/flash_attention/kernel.py::flash_attention_kernel
//   (body _attn_kernel)
// and takes the model's layout directly, so no repeat or transpose is
// made around it:
//
//   q (B, S, H, D), k and v (B, T, Hkv, D), all float32 or all bfloat16,
//   contiguous; H a multiple of Hkv (query head h reads kv head h / G, with
//   G = H / Hkv: the group is indexed, never repeated).
//   -> o (B, S, H, D) in q's dtype.
//
// Query row i and key row j sit at positions i and j (a sequence attending
// itself from position 0).  Key j is attended by row i iff j < t_real, and
// j <= i when causal, and j > i - window when window > 0.  The running max,
// normaliser and accumulator are fp32.  A row with no key to attend (only
// when S > T under a window) comes out as the mean of v over the t_real
// rows: the value a plain softmax over equally masked scores gives.  Key
// tiles wholly outside the mask are skipped.
//
// Two routes, chosen by the wrapper from the dtype and D alone:
//
// * Tensor cores (bfloat16, D a multiple of 16 up to 256; every main-path
//   shape: D = 128 for qwen3-14b, 256 for recurrentgemma-2b, 64 for
//   minicpm-2b).  FlashAttention-2 on mma.sync.m16n8k16 (bf16 operands,
//   fp32 accumulation): one block of 4 warps per (q tile, head, batch
//   row), the kv loop inside the block (the TPU kernel's sequential grid
//   axis).  A warp owns two 16-row m-tiles (one at D > 128), so the tile is
//   128 q rows (64 at D > 128), and each K or V fragment it loads by
//   ldmatrix feeds both.  The q tile and two stages of K and of V
//   (separate buffers, 64-row tiles, 32-row at D > 128) sit in shared
//   memory as bf16, rows padded by 16 bytes so ldmatrix meets no bank
//   conflict: 102 KiB at D = 128, 99 KiB at D = 256, so two blocks share
//   an SM.  Tiles arrive by 16-byte cp.async; one barrier a tile, after
//   which the copy of the next tile is issued into the stage the last one
//   freed and runs while this one is scored.  Q.K^T reads K by ldmatrix,
//   P.V reads V by ldmatrix.trans; the probabilities never leave registers
//   (the score accumulators are re-packed as bf16 A-fragments).  A warp
//   skips a tile none of its rows attends; only tiles that cross a mask
//   edge evaluate the mask per element; the accumulator is rescaled only
//   when some row's running max moved.  The served head dims are compiled
//   for their exact D; other multiples of 16 take D at run time.
//   Numerics: Q.K^T sums exact bf16 products in fp32; the softmax scale is
//   applied to those fp32 scores, folded with log2(e) into one FMA before
//   ex2.approx (q is never scaled and rounded); the running max, the
//   normaliser (the sum of the fp32 probabilities) and the accumulator are
//   fp32.  P is rounded to bf16 for the P.V product: the one place the
//   result departs from the TPU kernel, which computes P.V in fp32.
//
// * CUDA cores (float32 at any D up to 256, bfloat16 at D not a multiple of
//   16, such as the sweeps' D = 8): the fp32 design of the port's first
//   flash kernel.  One block of 256 threads per (q tile of 64 rows, head,
//   batch row), q (pre-scaled by 1/sqrt(D) in fp32, as in the TPU kernel)
//   and one kv tile of 64 rows staged in shared memory as fp32, 4 x 4
//   register tiles of the scores, probabilities through shared memory.
//   TF32 would break fp32's 2e-4 contract, and no main path runs flash in
//   fp32.
//
// The backward (flash_attention_backward_launch; no TPU counterpart) has
// three designs, named by flash_attention_backward_kernel_of: on the
// tensor-core route at D = 64, 128 and 256 (every trained head dim) the
// wgmma design of namespace wg below (two launches: dQ with delta, then
// dK/dV); at other multiples of 16 the mma.sync design of namespace tc;
// on the CUDA-core route the fp32 design of namespace cc.  The last two
// launch a delta pre-pass, dK/dV and dQ.
//
// Bound on the H100 (3.35 TB/s HBM; 989 TFLOP/s dense bf16 on the tensor
// cores): at qwen3-14b's 4096-token prefill (B=1, H=40, Hkv=8, D=128) the
// causal work is 4 D H S(S+1)/2 = 171.8 GFLOP against about 101 MB of q,
// k, v and o, so the kernel is bound by operations: 0.174 ms.  mma.sync
// reaches only part of the tensor cores' rate (wgmma alone reaches all of
// it), and the kernel is bound by latency before that: each warp's
// ldmatrix -> mma chains, its softmax (an ex2 per score on the
// special-function units, shuffles for the row max) and the barrier a
// tile leave the tensor pipes idle unless another warp has products
// ready, and the two blocks on an SM overlap one's softmax with the
// other's products only by chance.  Levers left: wgmma on 64-row
// warpgroup tiles with B read from shared memory (no ldmatrix), TMA with
// mbarriers and a producer warp, two consumer warpgroups ping-ponging
// softmax and products, and fp8.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kMaxD = 256;

// ---------------------------------------------------------------------------
// CUDA-core route (float32; bfloat16 at D not a multiple of 16)

namespace cc {

constexpr int kThreads = 256;
constexpr int kGrid = 16;       // 16 x 16 thread grid
constexpr int kRows = 4;        // q rows per thread (strided by kGrid)
constexpr int kBQ = kGrid * kRows;   // 64 q rows per block
constexpr int kBK = 64;              // kv rows per tile
constexpr int kCols = kBK / kGrid;   // score columns per thread

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

struct Layout {
    int ld;      // leading dimension of the q and kv tiles (D + 1, odd for even D)
    int q, kv, p, total;     // offsets and size in floats
    __host__ __device__ explicit Layout(int D) {
        ld = D + 1;
        q = 0;
        kv = q + kBQ * ld;
        p = kv + kBK * ld;
        total = p + kBQ * (kBK + 1);
    }
};

// Stage rows [r0, r0 + nrows) of one head of x (row stride `stride`
// elements) into tile[row * ld + c] as fp32 times `scale`; rows at or past
// `limit` are zero.
template <typename T>
__device__ __forceinline__ void stage(float* tile, const T* x, int64_t stride, int r0,
                                      int nrows, int limit, int D, int ld, float scale) {
    for (int idx = threadIdx.x; idx < nrows * D; idx += kThreads) {
        const int row = idx / D, c = idx - row * D;
        const int r = r0 + row;
        tile[row * ld + c] = r < limit ? to_f32(x[(int64_t)r * stride + c]) * scale : 0.f;
    }
}

template <typename T, int DPT>
__global__ void __launch_bounds__(kThreads)
flash_attn_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                  T* __restrict__ o, float* __restrict__ lse, int S, int T_, int H, int Hkv,
                  int D, int t_real, int causal, int window, float scale) {
    extern __shared__ float smem[];
    const Layout lay(D);
    float* qs = smem + lay.q;
    float* kv = smem + lay.kv;
    float* ps = smem + lay.p;
    const int ld = lay.ld;

    const int tid = threadIdx.x, tx = tid % kGrid, ty = tid / kGrid;
    const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;     // longest causal tiles first
    const int h = blockIdx.y, b = blockIdx.z;
    const int hk = h / (H / Hkv);
    const int q1 = min(q0 + kBQ, S);

    const int64_t qstride = (int64_t)H * D, kstride = (int64_t)Hkv * D;
    const T* qb = q + ((int64_t)b * S * H + h) * D;
    const T* kb = k + ((int64_t)b * T_ * Hkv + hk) * D;
    const T* vb = v + ((int64_t)b * T_ * Hkv + hk) * D;

    stage(qs, qb, qstride, q0, kBQ, S, D, ld, scale);

    float m[kRows], l[kRows], acc[kRows][DPT];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
        m[i] = kNegInf;
        l[i] = 0.f;
#pragma unroll
        for (int c = 0; c < DPT; ++c) acc[i][c] = 0.f;
    }

    // key tiles that can hold a valid key for some row of [q0, q1)
    int lo = 0, hi = t_real;
    if (window > 0) lo = max(0, q0 - window + 1);
    if (causal) hi = min(hi, q1);
    const int kt_lo = lo / kBK, kt_hi = hi > lo ? (hi - 1) / kBK + 1 : kt_lo;

    for (int kt = kt_lo; kt < kt_hi; ++kt) {
        const int k0 = kt * kBK;
        __syncthreads();                      // the last P.V is done with kv and ps
        stage(kv, kb, kstride, k0, kBK, T_, D, ld, 1.f);
        __syncthreads();

        float s[kRows][kCols];
#pragma unroll
        for (int i = 0; i < kRows; ++i)
#pragma unroll
            for (int j = 0; j < kCols; ++j) s[i][j] = 0.f;
        for (int d = 0; d < D; ++d) {
            float qv[kRows], kk[kCols];
#pragma unroll
            for (int i = 0; i < kRows; ++i) qv[i] = qs[(ty + kGrid * i) * ld + d];
#pragma unroll
            for (int j = 0; j < kCols; ++j) kk[j] = kv[(tx + kGrid * j) * ld + d];
#pragma unroll
            for (int i = 0; i < kRows; ++i)
#pragma unroll
                for (int j = 0; j < kCols; ++j) s[i][j] = fmaf(qv[i], kk[j], s[i][j]);
        }

#pragma unroll
        for (int i = 0; i < kRows; ++i) {
            const int r = q0 + ty + kGrid * i;
            float mx = kNegInf;
#pragma unroll
            for (int j = 0; j < kCols; ++j) {
                const int c = k0 + tx + kGrid * j;
                bool ok = c < t_real;
                if (causal) ok = ok && c <= r;
                if (window > 0) ok = ok && c > r - window;
                s[i][j] = ok ? s[i][j] : kNegInf;
                mx = fmaxf(mx, s[i][j]);
            }
#pragma unroll
            for (int off = kGrid / 2; off > 0; off /= 2)
                mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
            const float m_new = fmaxf(m[i], mx);
            const float alpha = expf(m[i] - m_new);
            float sum = 0.f;
#pragma unroll
            for (int j = 0; j < kCols; ++j) {
                const float p = expf(s[i][j] - m_new);
                sum += p;
                ps[(ty + kGrid * i) * (kBK + 1) + tx + kGrid * j] = p;
            }
#pragma unroll
            for (int off = kGrid / 2; off > 0; off /= 2)
                sum += __shfl_xor_sync(0xffffffffu, sum, off);
            l[i] = l[i] * alpha + sum;
            m[i] = m_new;
#pragma unroll
            for (int c = 0; c < DPT; ++c) acc[i][c] *= alpha;
        }
        __syncthreads();                      // everyone is done with K
        stage(kv, vb, kstride, k0, kBK, T_, D, ld, 1.f);
        __syncthreads();

        for (int j = 0; j < kBK; ++j) {
            float p[kRows];
#pragma unroll
            for (int i = 0; i < kRows; ++i) p[i] = ps[(ty + kGrid * i) * (kBK + 1) + j];
#pragma unroll
            for (int c = 0; c < DPT; ++c) {
                const int col = tx + kGrid * c;
                const float vv = col < D ? kv[j * ld + col] : 0.f;
#pragma unroll
                for (int i = 0; i < kRows; ++i) acc[i][c] = fmaf(p[i], vv, acc[i][c]);
            }
        }
    }

    // rows that met no valid key: the mean of v over the t_real rows
    bool empty = false;
#pragma unroll
    for (int i = 0; i < kRows; ++i)
        empty = empty || (q0 + ty + kGrid * i < S && m[i] == kNegInf);
    if (__syncthreads_or(empty)) {
        float colsum[DPT];
#pragma unroll
        for (int c = 0; c < DPT; ++c) colsum[c] = 0.f;
        for (int k0 = 0; k0 < t_real; k0 += kBK) {
            __syncthreads();
            stage(kv, vb, kstride, k0, kBK, t_real, D, ld, 1.f);
            __syncthreads();
            for (int j = 0; j < min(kBK, t_real - k0); ++j)
#pragma unroll
                for (int c = 0; c < DPT; ++c) {
                    const int col = tx + kGrid * c;
                    colsum[c] += col < D ? kv[j * ld + col] : 0.f;
                }
        }
#pragma unroll
        for (int i = 0; i < kRows; ++i)
            if (m[i] == kNegInf) {
                l[i] = (float)t_real;
#pragma unroll
                for (int c = 0; c < DPT; ++c) acc[i][c] = colsum[c];
            }
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
        const int r = q0 + ty + kGrid * i;
        if (r >= q1) continue;
        const float inv = 1.f / fmaxf(l[i], 1e-30f);
        if (lse != nullptr && tx == 0)
            lse[((int64_t)b * H + h) * S + r] = m[i] + logf(fmaxf(l[i], 1e-30f));
        T* orow = o + (((int64_t)b * S + r) * H + h) * D;
#pragma unroll
        for (int c = 0; c < DPT; ++c) {
            const int col = tx + kGrid * c;
            if (col < D) store(orow + col, acc[i][c] * inv);
        }
    }
}


template <typename T, int DPT>
cudaError_t launch_dpt(const void* q, const void* k, const void* v, void* o, float* lse, int B,
                       int S, int T_, int H, int Hkv, int D, int t_real, int causal, int window,
                       cudaStream_t stream) {
    const int smem = Layout(D).total * (int)sizeof(float);
    if (smem > 48 * 1024) {     // above 48 KB only after opting in
        cudaError_t e = cudaFuncSetAttribute(
            flash_attn_kernel<T, DPT>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (e != cudaSuccess) return e;
    }
    const dim3 grid((S + kBQ - 1) / kBQ, H, B);
    flash_attn_kernel<T, DPT><<<grid, kThreads, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<T*>(o), lse, S, T_, H, Hkv, D, t_real, causal, window,
        (float)(1.0 / sqrt((double)D)));
    return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, float* lse, int B,
                   int S, int T_, int H, int Hkv, int D, int t_real, int causal, int window,
                   cudaStream_t stream) {
#define FA_CC(DPT) \
    launch_dpt<T, DPT>(q, k, v, o, lse, B, S, T_, H, Hkv, D, t_real, causal, window, stream)
    if (D <= 16) return FA_CC(1);
    if (D <= 32) return FA_CC(2);
    if (D <= 64) return FA_CC(4);
    if (D <= 128) return FA_CC(8);
    return FA_CC(16);
#undef FA_CC
}

// -- backward pre-pass: delta[b, h, i] = sum_d dO[b, i, h, d] O[b, i, h, d] in fp32,
// one warp per (b, i, h) row of the model's layout
template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                       float* __restrict__ delta, int S, int H, int D, int64_t rows) {
    const int64_t row = (int64_t)blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
    const int lane = threadIdx.x & 31;
    if (row >= rows) return;
    const T* orow = o + row * D;
    const T* drow = dout + row * D;
    float acc = 0.f;
    for (int d = lane; d < D; d += 32) acc = fmaf(to_f32(drow[d]), to_f32(orow[d]), acc);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) {
        const int64_t sh = (int64_t)S * H;
        const int64_t b = row / sh, rem = row - b * sh;
        const int i = (int)(rem / H), h = (int)(rem - (int64_t)i * H);
        delta[(b * H + h) * S + i] = acc;
    }
}

template <typename T>
cudaError_t launch_delta(const void* o, const void* dout, float* delta, int B, int S, int H,
                         int D, cudaStream_t stream) {
    const int64_t rows = (int64_t)B * S * H;
    const int per = kThreads / 32;
    flash_bwd_delta_kernel<T><<<(unsigned)((rows + per - 1) / per), kThreads, 0, stream>>>(
        static_cast<const T*>(o), static_cast<const T*>(dout), delta, S, H, D, rows);
    return cudaGetLastError();
}

// -- backward (aligned self-attention: S == T == t_real, causal, optional window)
//
// dK/dV: one block per (32-row kv tile, kv head, batch row), looping over the
// 32-row q tiles that can see its keys and, inside each, over the G query
// heads of its group, so GQA's sum over the group is taken in the block.
// dQ: one block per (32-row q tile, head, batch row), looping over kv tiles.
// Scores, P = exp(s scale - lse) and dS = P (dP - delta) are fp32; a 16 x 16
// thread grid owns 2 x 2 of each 32 x 32 tile and 2 rows x ceil(D/16)
// columns of each accumulator.

constexpr int kBR = 32;                    // q and kv rows per backward tile

struct BwdLayout {
    int ld;                                 // D + 1
    int k, v, q, dout, p, ds, total;        // offsets and size in floats
    __host__ __device__ explicit BwdLayout(int D) {
        ld = D + 1;
        k = 0;
        v = k + kBR * ld;
        q = v + kBR * ld;
        dout = q + kBR * ld;
        p = dout + kBR * ld;
        ds = p + kBR * (kBR + 1);
        total = ds + kBR * (kBR + 1);
    }
};

__device__ __forceinline__ bool attends(int i, int j, int S, int window) {
    return i < S && j <= i && (window <= 0 || j > i - window);
}

template <typename T, int DPT>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ lse, const float* __restrict__ delta,
                      T* __restrict__ dk, T* __restrict__ dv, int S, int H, int Hkv, int D,
                      int window, float scale) {
    extern __shared__ float smem[];
    const BwdLayout lay(D);
    const int ld = lay.ld;
    float *ks = smem + lay.k, *vs = smem + lay.v, *qs = smem + lay.q, *dos = smem + lay.dout;
    float *ps = smem + lay.p, *dss = smem + lay.ds;
    const int tid = threadIdx.x, tx = tid % kGrid, ty = tid / kGrid;
    const int k0 = blockIdx.x * kBR, hk = blockIdx.y, b = blockIdx.z;
    const int G = H / Hkv;
    const int64_t qstride = (int64_t)H * D, kstride = (int64_t)Hkv * D;
    const T* kb = k + ((int64_t)b * S * Hkv + hk) * D;
    const T* vb = v + ((int64_t)b * S * Hkv + hk) * D;
    stage(ks, kb, kstride, k0, kBR, S, D, ld, 1.f);
    stage(vs, vb, kstride, k0, kBR, S, D, ld, 1.f);

    float dka[2][DPT], dva[2][DPT];
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int c = 0; c < DPT; ++c) dka[a][c] = dva[a][c] = 0.f;

    // q rows that attend a key of [k0, k0 + kBR): i >= k0, and i < j + window
    const int hi = window > 0 ? min(S, k0 + kBR - 1 + window) : S;
    for (int q0 = (k0 / kBR) * kBR; q0 < hi; q0 += kBR) {
        for (int g = 0; g < G; ++g) {
            const int h = hk * G + g;
            const T* qb = q + ((int64_t)b * S * H + h) * D;
            const T* db = dout + ((int64_t)b * S * H + h) * D;
            const float* lrow = lse + ((int64_t)b * H + h) * S;
            const float* drow = delta + ((int64_t)b * H + h) * S;
            __syncthreads();                    // the last tile's products are done
            stage(qs, qb, qstride, q0, kBR, S, D, ld, 1.f);
            stage(dos, db, qstride, q0, kBR, S, D, ld, 1.f);
            __syncthreads();
            // kv row j = k0 + ty + 16 a, q row i = q0 + tx + 16 c
            float s[2][2], dp[2][2];
#pragma unroll
            for (int a = 0; a < 2; ++a)
#pragma unroll
                for (int c = 0; c < 2; ++c) s[a][c] = dp[a][c] = 0.f;
            for (int d = 0; d < D; ++d) {
                float kk[2], vv[2], qq[2], oo[2];
#pragma unroll
                for (int a = 0; a < 2; ++a) {
                    kk[a] = ks[(ty + kGrid * a) * ld + d];
                    vv[a] = vs[(ty + kGrid * a) * ld + d];
                }
#pragma unroll
                for (int c = 0; c < 2; ++c) {
                    qq[c] = qs[(tx + kGrid * c) * ld + d];
                    oo[c] = dos[(tx + kGrid * c) * ld + d];
                }
#pragma unroll
                for (int a = 0; a < 2; ++a)
#pragma unroll
                    for (int c = 0; c < 2; ++c) {
                        s[a][c] = fmaf(kk[a], qq[c], s[a][c]);
                        dp[a][c] = fmaf(vv[a], oo[c], dp[a][c]);
                    }
            }
#pragma unroll
            for (int c = 0; c < 2; ++c) {
                const int i = q0 + tx + kGrid * c;
                const float li = i < S ? lrow[i] : 0.f, di = i < S ? drow[i] : 0.f;
#pragma unroll
                for (int a = 0; a < 2; ++a) {
                    const int j = k0 + ty + kGrid * a;
                    const float p = attends(i, j, S, window) ? expf(s[a][c] * scale - li) : 0.f;
                    ps[(ty + kGrid * a) * (kBR + 1) + tx + kGrid * c] = p;
                    dss[(ty + kGrid * a) * (kBR + 1) + tx + kGrid * c] = p * (dp[a][c] - di);
                }
            }
            __syncthreads();
            for (int i = 0; i < kBR; ++i) {
                float pj[2], dj[2];
#pragma unroll
                for (int a = 0; a < 2; ++a) {
                    pj[a] = ps[(ty + kGrid * a) * (kBR + 1) + i];
                    dj[a] = dss[(ty + kGrid * a) * (kBR + 1) + i];
                }
#pragma unroll
                for (int c = 0; c < DPT; ++c) {
                    const int col = tx + kGrid * c;
                    const float ov = col < D ? dos[i * ld + col] : 0.f;
                    const float qv = col < D ? qs[i * ld + col] : 0.f;
#pragma unroll
                    for (int a = 0; a < 2; ++a) {
                        dva[a][c] = fmaf(pj[a], ov, dva[a][c]);
                        dka[a][c] = fmaf(dj[a], qv, dka[a][c]);
                    }
                }
            }
        }
    }
#pragma unroll
    for (int a = 0; a < 2; ++a) {
        const int j = k0 + ty + kGrid * a;
        if (j >= S) continue;
        const int64_t off = (((int64_t)b * S + j) * Hkv + hk) * D;
#pragma unroll
        for (int c = 0; c < DPT; ++c) {
            const int col = tx + kGrid * c;
            if (col < D) {
                store(dk + off + col, dka[a][c] * scale);
                store(dv + off + col, dva[a][c]);
            }
        }
    }
}

template <typename T, int DPT>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq, int S, int H, int Hkv,
                    int D, int window, float scale) {
    extern __shared__ float smem[];
    const BwdLayout lay(D);
    const int ld = lay.ld;
    float *ks = smem + lay.k, *vs = smem + lay.v, *qs = smem + lay.q, *dos = smem + lay.dout;
    float* dss = smem + lay.ds;
    const int tid = threadIdx.x, tx = tid % kGrid, ty = tid / kGrid;
    const int q0 = (gridDim.x - 1 - blockIdx.x) * kBR;      // longest rows first
    const int h = blockIdx.y, b = blockIdx.z;
    const int hk = h / (H / Hkv);
    const int64_t qstride = (int64_t)H * D, kstride = (int64_t)Hkv * D;
    const T* kb = k + ((int64_t)b * S * Hkv + hk) * D;
    const T* vb = v + ((int64_t)b * S * Hkv + hk) * D;
    stage(qs, q + ((int64_t)b * S * H + h) * D, qstride, q0, kBR, S, D, ld, 1.f);
    stage(dos, dout + ((int64_t)b * S * H + h) * D, qstride, q0, kBR, S, D, ld, 1.f);
    float li[2], di[2];
#pragma unroll
    for (int a = 0; a < 2; ++a) {
        const int i = q0 + ty + kGrid * a;
        li[a] = i < S ? lse[((int64_t)b * H + h) * S + i] : 0.f;
        di[a] = i < S ? delta[((int64_t)b * H + h) * S + i] : 0.f;
    }
    float dqa[2][DPT];
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int c = 0; c < DPT; ++c) dqa[a][c] = 0.f;

    const int lo = window > 0 ? max(0, q0 - window + 1) : 0;
    const int hi = min(S, q0 + kBR);
    for (int k0 = (lo / kBR) * kBR; k0 < hi; k0 += kBR) {
        __syncthreads();
        stage(ks, kb, kstride, k0, kBR, S, D, ld, 1.f);
        stage(vs, vb, kstride, k0, kBR, S, D, ld, 1.f);
        __syncthreads();
        // q row i = q0 + ty + 16 a, kv row j = k0 + tx + 16 c
        float s[2][2], dp[2][2];
#pragma unroll
        for (int a = 0; a < 2; ++a)
#pragma unroll
            for (int c = 0; c < 2; ++c) s[a][c] = dp[a][c] = 0.f;
        for (int d = 0; d < D; ++d) {
            float qq[2], oo[2], kk[2], vv[2];
#pragma unroll
            for (int a = 0; a < 2; ++a) {
                qq[a] = qs[(ty + kGrid * a) * ld + d];
                oo[a] = dos[(ty + kGrid * a) * ld + d];
            }
#pragma unroll
            for (int c = 0; c < 2; ++c) {
                kk[c] = ks[(tx + kGrid * c) * ld + d];
                vv[c] = vs[(tx + kGrid * c) * ld + d];
            }
#pragma unroll
            for (int a = 0; a < 2; ++a)
#pragma unroll
                for (int c = 0; c < 2; ++c) {
                    s[a][c] = fmaf(qq[a], kk[c], s[a][c]);
                    dp[a][c] = fmaf(oo[a], vv[c], dp[a][c]);
                }
        }
#pragma unroll
        for (int a = 0; a < 2; ++a) {
            const int i = q0 + ty + kGrid * a;
#pragma unroll
            for (int c = 0; c < 2; ++c) {
                const int j = k0 + tx + kGrid * c;
                const float p = attends(i, j, S, window) ? expf(s[a][c] * scale - li[a]) : 0.f;
                dss[(ty + kGrid * a) * (kBR + 1) + tx + kGrid * c] = p * (dp[a][c] - di[a]);
            }
        }
        __syncthreads();
        for (int j = 0; j < kBR; ++j) {
            float dj[2];
#pragma unroll
            for (int a = 0; a < 2; ++a) dj[a] = dss[(ty + kGrid * a) * (kBR + 1) + j];
#pragma unroll
            for (int c = 0; c < DPT; ++c) {
                const int col = tx + kGrid * c;
                const float kv_ = col < D ? ks[j * ld + col] : 0.f;
#pragma unroll
                for (int a = 0; a < 2; ++a) dqa[a][c] = fmaf(dj[a], kv_, dqa[a][c]);
            }
        }
    }
#pragma unroll
    for (int a = 0; a < 2; ++a) {
        const int i = q0 + ty + kGrid * a;
        if (i >= S) continue;
        T* row = dq + (((int64_t)b * S + i) * H + h) * D;
#pragma unroll
        for (int c = 0; c < DPT; ++c) {
            const int col = tx + kGrid * c;
            if (col < D) store(row + col, dqa[a][c] * scale);
        }
    }
}

template <typename T, int DPT>
cudaError_t launch_bwd_dpt(const void* q, const void* k, const void* v, const void* dout,
                           const float* lse, const float* delta, void* dq, void* dk, void* dv,
                           int B, int S, int H, int Hkv, int D, int window, cudaStream_t stream) {
    const int smem = BwdLayout(D).total * (int)sizeof(float);
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(flash_bwd_dkdv_kernel<T, DPT>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (e != cudaSuccess) return e;
        e = cudaFuncSetAttribute(flash_bwd_dq_kernel<T, DPT>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (e != cudaSuccess) return e;
    }
    const float scale = (float)(1.0 / sqrt((double)D));
    const int tiles = (S + kBR - 1) / kBR;
    const T *q_ = static_cast<const T*>(q), *k_ = static_cast<const T*>(k);
    const T *v_ = static_cast<const T*>(v), *do_ = static_cast<const T*>(dout);
    flash_bwd_dkdv_kernel<T, DPT><<<dim3(tiles, Hkv, B), kThreads, smem, stream>>>(
        q_, k_, v_, do_, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), S, H, Hkv, D,
        window, scale);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    flash_bwd_dq_kernel<T, DPT><<<dim3(tiles, H, B), kThreads, smem, stream>>>(
        q_, k_, v_, do_, lse, delta, static_cast<T*>(dq), S, H, Hkv, D, window, scale);
    return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd(const void* q, const void* k, const void* v, const void* dout,
                       const float* lse, const float* delta, void* dq, void* dk, void* dv, int B,
                       int S, int H, int Hkv, int D, int window, cudaStream_t stream) {
#define FA_CC_BWD(DPT) \
    launch_bwd_dpt<T, DPT>(q, k, v, dout, lse, delta, dq, dk, dv, B, S, H, Hkv, D, window, stream)
    if (D <= 16) return FA_CC_BWD(1);
    if (D <= 32) return FA_CC_BWD(2);
    if (D <= 64) return FA_CC_BWD(4);
    if (D <= 128) return FA_CC_BWD(8);
    return FA_CC_BWD(16);
#undef FA_CC_BWD
}

}  // namespace cc

// ---------------------------------------------------------------------------
// Tensor-core route (bfloat16, D a multiple of 16 up to 256)

namespace tc {

// Chosen on the H100 among 4 or 8 warps, 1 or 2 m-tiles a warp, kv tiles
// of 32 or 64 rows, 2 or 3 stages, q fragments in registers or re-read, and
// 1 to 4 blocks an SM (see PERF.md): 4 warps of 2 m-tiles (128 q rows)
// over 64-key tiles, two stages, two blocks an SM, q re-read from shared
// memory.  At D > 128 the warp's 16 x D fp32 accumulator alone takes 128
// registers a thread, so there a warp holds one m-tile (64 q rows) and kv
// tiles are 32 rows.
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kStages = 2;                // K and V tiles in flight

// DT is D rounded up to 32, 64, 128 or 256: it sizes the register arrays,
// and loops over 16-column steps past D are skipped
template <int DT>
struct Tile {
    static constexpr int BK = DT > 128 ? 32 : 64;     // kv rows per tile
    static constexpr int MR = DT > 128 ? 1 : 2;       // 16-row m-tiles per warp
    static constexpr int BQ = 16 * MR * kWarps;       // q rows per block
};

__host__ __device__ constexpr int row_elems(int D) { return D + 8; }   // 16-byte pad

template <int DT>
__host__ __device__ constexpr int smem_bytes(int D) {
    return (Tile<DT>::BQ + 2 * kStages * Tile<DT>::BK) * row_elems(D) * 2;   // q, K and V stages
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
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats as a bf16 pair, lo in the low half (the lower column index)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
}

// Copy rows [r0, r0 + NR) of one head (row stride `stride` elements) into a
// padded bf16 tile by 16-byte cp.async; rows at or past `limit` become zero.
template <int NR>
__device__ __forceinline__ void load_tile(__nv_bfloat16* tile, const __nv_bfloat16* x,
                                          int64_t stride, int r0, int limit, int D) {
    const int chunks = D >> 3, ld = row_elems(D);
    for (int i = threadIdx.x; i < NR * chunks; i += kThreads) {
        const int row = i / chunks, c = (i - row * chunks) << 3;
        const int r = r0 + row;
        const bool ok = r < limit;
        cp_async16(smem_addr(tile + row * ld + c), x + (ok ? (int64_t)r * stride : 0) + c, ok);
    }
}

// Fragment layout of m16n8k16 (lane = 4 * gr + tq): a score or output
// block c[0..1] holds row gr, columns 2 tq and 2 tq + 1; c[2..3] the same
// columns of row gr + 8.  A warp owns MR such 16-row m-tiles, which share
// every K and V fragment it loads.  Scores are raw fp32 dot products; the
// running max is kept raw, and exp2f takes fma(s, scale log2 e, -max x
// scale log2 e).  A masked score is -inf, and a row whose running max is
// still -inf has met no valid key.
__device__ __forceinline__ float fast_exp2(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
    return y;
}

// DC > 0 fixes the head dim at compile time (D = DC), so every shared-memory
// offset folds into an immediate; DC = 0 takes D at run time (up to DT).
template <int DT, int DC>
__global__ void __launch_bounds__(kThreads, 2)
flash_attn_kernel_mma(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                      float* __restrict__ lse, int S, int T_, int H, int Hkv, int D_run,
                      int t_real, int causal, int window, float scale_log2) {
    const int D = DC > 0 ? DC : D_run;
    constexpr int BK = Tile<DT>::BK;
    constexpr int MR = Tile<DT>::MR;           // 16-row m-tiles per warp
    constexpr int BQ = Tile<DT>::BQ;
    constexpr int WR = 16 * MR;                // rows per warp
    constexpr int NB = BK / 8;                 // 8-key score blocks per tile
    constexpr int DB = DT / 8;                 // 8-column output blocks
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int ld = row_elems(D);
    __nv_bfloat16* sq = reinterpret_cast<__nv_bfloat16*>(smem_raw);
    __nv_bfloat16* sk = sq + BQ * ld;          // kStages stages of BK rows
    __nv_bfloat16* sv = sk + kStages * BK * ld;

    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int gr = lane >> 2, tq = lane & 3;
    const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;      // longest causal tiles first
    const int h = blockIdx.y, b = blockIdx.z;
    const int hk = h / (H / Hkv);
    const int q1 = min(q0 + BQ, S);
    const int64_t qstride = (int64_t)H * D, kstride = (int64_t)Hkv * D;
    const __nv_bfloat16* qb = q + ((int64_t)b * S * H + h) * D;
    const __nv_bfloat16* kb = k + ((int64_t)b * T_ * Hkv + hk) * D;
    const __nv_bfloat16* vb = v + ((int64_t)b * T_ * Hkv + hk) * D;

    // key tiles that can hold a valid key for some row of [q0, q1)
    int lo = 0, hi = t_real;
    if (window > 0) lo = max(0, q0 - window + 1);
    if (causal) hi = min(hi, q1);
    const int kt_lo = lo / BK, kt_hi = hi > lo ? (hi - 1) / BK + 1 : kt_lo;

    // one cp.async group per kv tile (q rides with the first); the first
    // kStages - 1 tiles are in flight before the loop
    load_tile<BQ>(sq, qb, qstride, q0, S, D);
#pragma unroll
    for (int i = 0; i < kStages - 1; ++i) {
        if (kt_lo + i < kt_hi) {
            load_tile<BK>(sk + i * BK * ld, kb, kstride, (kt_lo + i) * BK, t_real, D);
            load_tile<BK>(sv + i * BK * ld, vb, kstride, (kt_lo + i) * BK, t_real, D);
        }
        cp_async_commit();
    }

    const int w0 = q0 + WR * warp;                        // the warp's first row
    float acc[MR][DB][4];
    float m[MR][2], l[MR][2];
#pragma unroll
    for (int r = 0; r < MR; ++r) {
#pragma unroll
        for (int j = 0; j < DB; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[r][j][e] = 0.f;
        m[r][0] = m[r][1] = -INFINITY;
        l[r][0] = l[r][1] = 0.f;
    }

    // ldmatrix row addresses: A (q) rows lane & 15, column half lane >> 4;
    // B of Q.K^T (K rows as n) keys (lane & 7) + 8 (lane >> 4), d half
    // (lane >> 3) & 1; B of P.V (V^T by .trans) keys (lane & 7) + 8 ((lane
    // >> 3) & 1), d half lane >> 4
    const uint32_t q_addr = smem_addr(sq + (WR * warp + (lane & 15)) * ld + ((lane >> 4) << 3));
    const int k_off = ((lane & 7) + ((lane >> 4) << 3)) * ld + (((lane >> 3) & 1) << 3);
    const int v_off = ((lane & 7) + (((lane >> 3) & 1) << 3)) * ld + ((lane >> 4) << 3);

    for (int kt = kt_lo; kt < kt_hi; ++kt) {
        const int st = (kt - kt_lo) % kStages;
        cp_async_wait<kStages - 2>();   // this tile (and q) have landed
        // one barrier a tile: past it every warp is done with tile kt - 1,
        // whose stage the copy of tile kt + kStages - 1 now refills, in
        // flight while this tile is scored
        __syncthreads();
        {
            const int nt = kt + kStages - 1, ns = (st + kStages - 1) % kStages;
            if (nt < kt_hi) {
                load_tile<BK>(sk + ns * BK * ld, kb, kstride, nt * BK, t_real, D);
                load_tile<BK>(sv + ns * BK * ld, vb, kstride, nt * BK, t_real, D);
            }
            cp_async_commit();
        }

        const int k0 = kt * BK;
        // does any of the warp's rows attend a key of this tile?
        bool live = w0 < S;
        if (causal) live = live && k0 <= w0 + WR - 1;
        if (window > 0) live = live && k0 + BK - 1 > w0 - window;
        if (live) {
            const uint32_t ks = smem_addr(sk + st * BK * ld + k_off);
            const uint32_t vs = smem_addr(sv + st * BK * ld + v_off);
            float s[MR][NB][4];
#pragma unroll
            for (int r = 0; r < MR; ++r)
#pragma unroll
                for (int j = 0; j < NB; ++j)
#pragma unroll
                    for (int e = 0; e < 4; ++e) s[r][j][e] = 0.f;
#pragma unroll
            for (int kk = 0; kk < DT / 16; ++kk) {
                if (kk * 16 < D) {
                    uint32_t a[MR][4];
#pragma unroll
                    for (int r = 0; r < MR; ++r)
                        ldsm_x4(a[r], q_addr + (16 * r * ld + kk * 16) * 2);
#pragma unroll
                    for (int nb = 0; nb < BK / 16; ++nb) {
                        uint32_t bk[4];
                        ldsm_x4(bk, ks + (nb * 16 * ld + kk * 16) * 2);
#pragma unroll
                        for (int r = 0; r < MR; ++r) {
                            mma_bf16(s[r][2 * nb], a[r], bk[0], bk[1]);
                            mma_bf16(s[r][2 * nb + 1], a[r], bk[2], bk[3]);
                        }
                    }
                }
            }

            // the mask only on tiles that cross its edge
            const bool full = k0 + BK <= t_real && (!causal || k0 + BK - 1 <= w0) &&
                              (window <= 0 || k0 > w0 + WR - 1 - window);
            uint32_t pa[MR][BK / 16][4];
#pragma unroll
            for (int r = 0; r < MR; ++r) {
                const int row0 = w0 + 16 * r + gr, row1 = row0 + 8;
                float mx0 = m[r][0], mx1 = m[r][1];
#pragma unroll
                for (int j = 0; j < NB; ++j) {
                    if (!full) {
#pragma unroll
                        for (int e = 0; e < 4; ++e) {
                            const int c = k0 + 8 * j + 2 * tq + (e & 1);
                            const int rr = e < 2 ? row0 : row1;
                            bool ok = c < t_real;
                            if (causal) ok = ok && c <= rr;
                            if (window > 0) ok = ok && c > rr - window;
                            if (!ok) s[r][j][e] = -INFINITY;
                        }
                    }
                    mx0 = fmaxf(mx0, fmaxf(s[r][j][0], s[r][j][1]));
                    mx1 = fmaxf(mx1, fmaxf(s[r][j][2], s[r][j][3]));
                }
                // a row's 4 threads are lanes 4 gr .. 4 gr + 3
                mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
                mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
                mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
                mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
                const float base0 = mx0 == -INFINITY ? 0.f : mx0 * scale_log2;
                const float base1 = mx1 == -INFINITY ? 0.f : mx1 * scale_log2;
                const float alpha0 = fast_exp2(m[r][0] * scale_log2 - base0);
                const float alpha1 = fast_exp2(m[r][1] * scale_log2 - base1);
                m[r][0] = mx0;
                m[r][1] = mx1;

                // P in registers, re-packed as bf16 A-fragments of P.V: the A
                // fragment of keys [16 kb, 16 kb + 16) is score blocks 2 kb, 2 kb + 1
                float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
                for (int j = 0; j < NB; ++j) {
                    const float p0 = fast_exp2(fmaf(s[r][j][0], scale_log2, -base0));
                    const float p1 = fast_exp2(fmaf(s[r][j][1], scale_log2, -base0));
                    const float p2 = fast_exp2(fmaf(s[r][j][2], scale_log2, -base1));
                    const float p3 = fast_exp2(fmaf(s[r][j][3], scale_log2, -base1));
                    rs0 += p0 + p1;
                    rs1 += p2 + p3;
                    pa[r][j >> 1][(j & 1) * 2] = pack_bf16(p0, p1);
                    pa[r][j >> 1][(j & 1) * 2 + 1] = pack_bf16(p2, p3);
                }
                l[r][0] = l[r][0] * alpha0 + rs0;     // partial over this thread's columns
                l[r][1] = l[r][1] * alpha1 + rs1;
                // alpha is exactly 1 where the row's max did not move: skip the
                // rescale when that holds for every row of the m-tile
                if (__any_sync(0xffffffffu, alpha0 != 1.f || alpha1 != 1.f)) {
#pragma unroll
                    for (int j = 0; j < DB; ++j) {
                        acc[r][j][0] *= alpha0;
                        acc[r][j][1] *= alpha0;
                        acc[r][j][2] *= alpha1;
                        acc[r][j][3] *= alpha1;
                    }
                }
            }
#pragma unroll
            for (int kb2 = 0; kb2 < BK / 16; ++kb2) {
#pragma unroll
                for (int db = 0; db < DT / 16; ++db) {
                    if (db * 16 < D) {
                        uint32_t bv[4];
                        ldsm_x4_trans(bv, vs + (kb2 * 16 * ld + db * 16) * 2);
#pragma unroll
                        for (int r = 0; r < MR; ++r) {
                            mma_bf16(acc[r][2 * db], pa[r][kb2], bv[0], bv[1]);
                            mma_bf16(acc[r][2 * db + 1], pa[r][kb2], bv[2], bv[3]);
                        }
                    }
                }
            }
        }
    }
    cp_async_wait<0>();

    bool empty = false;
#pragma unroll
    for (int r = 0; r < MR; ++r) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
            l[r][i] += __shfl_xor_sync(0xffffffffu, l[r][i], 1);
            l[r][i] += __shfl_xor_sync(0xffffffffu, l[r][i], 2);
            empty = empty || (w0 + 16 * r + gr + 8 * i < S && m[r][i] == -INFINITY);
        }
    }

    // rows that met no valid key: the mean of v over the t_real rows
    if (__syncthreads_or(empty)) {
        float* colsum = reinterpret_cast<float*>(sk);
        for (int d = tid; d < D; d += kThreads) {
            float sum = 0.f;
            for (int r = 0; r < t_real; ++r) sum += __bfloat162float(vb[(int64_t)r * kstride + d]);
            colsum[d] = sum;
        }
        __syncthreads();
#pragma unroll
        for (int r = 0; r < MR; ++r) {
#pragma unroll
            for (int i = 0; i < 2; ++i) {
                if (m[r][i] != -INFINITY) continue;
                l[r][i] = (float)t_real;
#pragma unroll
                for (int j = 0; j < DB; ++j) {
                    const int c = 8 * j + 2 * tq;
                    if (c < D) {
                        acc[r][j][2 * i] = colsum[c];
                        acc[r][j][2 * i + 1] = colsum[c + 1];
                    }
                }
            }
        }
    }

#pragma unroll
    for (int r = 0; r < MR; ++r) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
            const int row = w0 + 16 * r + gr + 8 * i;
            if (row >= q1) continue;
            const float inv = 1.f / fmaxf(l[r][i], 1e-30f);
            if (lse != nullptr && tq == 0)
                lse[((int64_t)b * H + h) * S + row] =
                    (m[r][i] * scale_log2 + log2f(fmaxf(l[r][i], 1e-30f))) * kLn2;
            __nv_bfloat16* orow = o + (((int64_t)b * S + row) * H + h) * D;
#pragma unroll
            for (int j = 0; j < DB; ++j) {
                const int c = 8 * j + 2 * tq;
                if (c < D)
                    *reinterpret_cast<uint32_t*>(orow + c) =
                        pack_bf16(acc[r][j][2 * i] * inv, acc[r][j][2 * i + 1] * inv);
            }
        }
    }
}

template <int DT, int DC>
cudaError_t launch_dt(const void* q, const void* k, const void* v, void* o, float* lse, int B,
                      int S, int T_, int H, int Hkv, int D, int t_real, int causal, int window,
                      cudaStream_t stream) {
    const int smem = smem_bytes<DT>(D);
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            flash_attn_kernel_mma<DT, DC>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (e != cudaSuccess) return e;
    }
    const dim3 grid((S + Tile<DT>::BQ - 1) / Tile<DT>::BQ, H, B);
    const double log2e = 1.4426950408889634;
    flash_attn_kernel_mma<DT, DC><<<grid, kThreads, smem, stream>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), lse, S, T_, H, Hkv,
        D, t_real, causal, window, (float)(log2e / sqrt((double)D)));
    return cudaGetLastError();
}

// the served head dims (64, 128, 256) and the powers of two below them are
// compiled for their exact D; other multiples of 16 take their tier's
// kernel with D at run time
cudaError_t launch(const void* q, const void* k, const void* v, void* o, float* lse, int B, int S,
                   int T_, int H, int Hkv, int D, int t_real, int causal, int window,
                   cudaStream_t stream) {
#define FA_TC(DT, DC) \
    launch_dt<DT, DC>(q, k, v, o, lse, B, S, T_, H, Hkv, D, t_real, causal, window, stream)
    switch (D) {
        case 16: return FA_TC(32, 16);
        case 32: return FA_TC(32, 32);
        case 64: return FA_TC(64, 64);
        case 128: return FA_TC(128, 128);
        case 256: return FA_TC(256, 256);
        default: break;
    }
    if (D < 64) return FA_TC(64, 0);
    if (D < 128) return FA_TC(128, 0);
    return FA_TC(256, 0);
#undef FA_TC
}

// -- backward (aligned self-attention: S == T == t_real, causal, optional window)
//
// The design for head dims the wgmma design (namespace wg) does not take.
// FlashAttention-2's backward on mma.sync.m16n8k16, bf16 operands and fp32
// accumulation, the probabilities recomputed from the forward's row lse:
//
// * dK/dV: one block of 4 warps per (64-row kv tile, kv head, column split,
//   batch row); a warp owns 16 kv rows.  The block walks the (q tile, query
//   head of the group) pairs that can see its keys, q and dO tiles in two
//   cp.async stages beside that tile's lse and delta.  Per pair a warp forms
//   S^T = K Q^T and dP^T = V dO^T (ldmatrix of K and V rows as A, q and dO rows
//   as B), P^T = exp2(S^T scale log2 e - lse log2 e) and dS^T = P^T (dP^T -
//   delta), re-packs both as bf16 A-fragments (P rounded to bf16 as the
//   forward rounds it for P.V) and accumulates dV += P^T dO and dK += dS^T Q
//   (ldmatrix.trans of dO and q) in fp32 registers.  GQA's sum over the group
//   stays in the block, so nothing is added atomically.  A warp's dK and dV
//   of 16 rows take D fp32 registers a thread: at D > 128 a block keeps 128
//   columns of them and the grid splits D, each split recomputing S^T and dP^T.
// * dQ: one block of 4 warps per (64-row q tile, head, batch row), a warp
//   owning 16 q rows; K and V tiles (64 rows, 32 at D > 128) in two stages.
//   Per tile S = Q K^T, dP = dO V^T, dS = P (dP - delta), dQ += dS K.
//
// Launches are deterministic: every output element is written by one thread
// after a fixed-order sum.

template <int DT>
struct BwdTile {
    static constexpr int BK = 16 * kWarps;            // kv rows of a dK/dV block
    static constexpr int BQ = DT > 64 ? 32 : 64;      // q rows per step of its loop
    static constexpr int DA = DT > 128 ? 128 : DT;    // dK/dV columns a block accumulates
    static constexpr int QB = 16 * kWarps;            // q rows of a dQ block
    static constexpr int KB = DT > 128 ? 32 : 64;     // kv rows per step of its loop
};

template <int DT>
__host__ __device__ constexpr int dkdv_smem_bytes(int D) {
    return (2 * BwdTile<DT>::BK + 4 * BwdTile<DT>::BQ) * row_elems(D) * 2 +
           4 * BwdTile<DT>::BQ * (int)sizeof(float);
}

template <int DT>
__host__ __device__ constexpr int dq_smem_bytes(int D) {
    return (2 * BwdTile<DT>::QB + 4 * BwdTile<DT>::KB) * row_elems(D) * 2;
}

__device__ __forceinline__ bool attends(int i, int j, int S, int window) {
    return i < S && j <= i && (window <= 0 || j > i - window);
}

template <int DT, int DC>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_mma(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                   const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                   const float* __restrict__ lse, const float* __restrict__ delta,
                   __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int S, int H,
                   int Hkv, int D_run, int window, float scale_log2, float scale) {
    const int D = DC > 0 ? DC : D_run;
    constexpr int BK = BwdTile<DT>::BK, BQ = BwdTile<DT>::BQ, DA = BwdTile<DT>::DA;
    constexpr int NQ = BQ / 8;                 // 8-column score blocks per q tile
    constexpr int NA = DA / 8;                 // 8-column accumulator blocks
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int ld = row_elems(D);
    __nv_bfloat16* sk = reinterpret_cast<__nv_bfloat16*>(smem_raw);
    __nv_bfloat16* sv = sk + BK * ld;
    __nv_bfloat16* sq = sv + BK * ld;          // two stages of BQ rows
    __nv_bfloat16* sdo = sq + 2 * BQ * ld;     // two stages of BQ rows
    float* sl = reinterpret_cast<float*>(sdo + 2 * BQ * ld);   // two stages of lse log2 e
    float* sd = sl + 2 * BQ;                                   // two stages of delta

    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int gr = lane >> 2, tq = lane & 3;
    const int nsplit = (D + DA - 1) / DA;
    const int k0 = blockIdx.x * BK, hk = blockIdx.y / nsplit;
    const int c0 = (blockIdx.y - hk * nsplit) * DA, b = blockIdx.z;
    const int G = H / Hkv;
    const int64_t qstride = (int64_t)H * D, kstride = (int64_t)Hkv * D;
    const __nv_bfloat16* qb = q + (int64_t)b * S * H * D;
    const __nv_bfloat16* ob = dout + (int64_t)b * S * H * D;

    load_tile<BK>(sk, k + ((int64_t)b * S * Hkv + hk) * D, kstride, k0, S, D);
    load_tile<BK>(sv, v + ((int64_t)b * S * Hkv + hk) * D, kstride, k0, S, D);
    // the q rows that attend a key of [k0, k0 + BK): i >= k0, and i < j + window
    const int qhi = window > 0 ? min(S, k0 + BK - 1 + window) : S;
    const int qt_lo = k0 / BQ, n_items = ((qhi - 1) / BQ + 1 - qt_lo) * G;
    auto issue = [&](int n, int st) {
        const int q0 = (qt_lo + n / G) * BQ, h = hk * G + n % G;
        load_tile<BQ>(sq + st * BQ * ld, qb + h * D, qstride, q0, S, D);
        load_tile<BQ>(sdo + st * BQ * ld, ob + h * D, qstride, q0, S, D);
        const float* lrow = lse + ((int64_t)b * H + h) * S;
        const float* drow = delta + ((int64_t)b * H + h) * S;
        for (int t = tid; t < BQ; t += kThreads) {
            const int i = q0 + t;
            sl[st * BQ + t] = i < S ? lrow[i] * kLog2e : INFINITY;
            sd[st * BQ + t] = i < S ? drow[i] : 0.f;
        }
    };
    issue(0, 0);
    cp_async_commit();

    float dva[NA][4], dka[NA][4];
#pragma unroll
    for (int j = 0; j < NA; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) dva[j][e] = dka[j][e] = 0.f;

    const int j0 = k0 + 16 * warp;            // the warp's first kv row
    const int a_off = (16 * warp + (lane & 15)) * ld + ((lane >> 4) << 3);
    const uint32_t k_a = smem_addr(sk + a_off), v_a = smem_addr(sv + a_off);
    const int b_off = ((lane & 7) + ((lane >> 4) << 3)) * ld + (((lane >> 3) & 1) << 3);
    const int t_off = ((lane & 7) + (((lane >> 3) & 1) << 3)) * ld + ((lane >> 4) << 3);

    for (int n = 0; n < n_items; ++n) {
        const int st = n & 1;
        cp_async_wait<0>();
        __syncthreads();                       // every warp is done with item n - 1
        if (n + 1 < n_items) issue(n + 1, st ^ 1);
        cp_async_commit();

        const int q0 = (qt_lo + n / G) * BQ;
        bool live = q0 + BQ - 1 >= j0;
        if (window > 0) live = live && q0 < j0 + 15 + window;
        if (!live) continue;
        const __nv_bfloat16* sqs = sq + st * BQ * ld;
        const __nv_bfloat16* sos = sdo + st * BQ * ld;
        const float* sls = sl + st * BQ;
        const float* sds = sd + st * BQ;
        float sT[NQ][4], dpT[NQ][4];
#pragma unroll
        for (int j = 0; j < NQ; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) sT[j][e] = dpT[j][e] = 0.f;
        const uint32_t qsb = smem_addr(sqs + b_off), osb = smem_addr(sos + b_off);
#pragma unroll
        for (int kk = 0; kk < DT / 16; ++kk) {
            if (kk * 16 < D) {
                uint32_t ak[4], av[4];
                ldsm_x4(ak, k_a + kk * 32);
                ldsm_x4(av, v_a + kk * 32);
#pragma unroll
                for (int nb = 0; nb < BQ / 16; ++nb) {
                    uint32_t bq[4], bo[4];
                    ldsm_x4(bq, qsb + (nb * 16 * ld + kk * 16) * 2);
                    ldsm_x4(bo, osb + (nb * 16 * ld + kk * 16) * 2);
                    mma_bf16(sT[2 * nb], ak, bq[0], bq[1]);
                    mma_bf16(sT[2 * nb + 1], ak, bq[2], bq[3]);
                    mma_bf16(dpT[2 * nb], av, bo[0], bo[1]);
                    mma_bf16(dpT[2 * nb + 1], av, bo[2], bo[3]);
                }
            }
        }
        // the mask only where the tile crosses its edge
        bool full = q0 >= j0 + 15 && q0 + BQ <= S;
        if (window > 0) full = full && q0 + BQ - 1 < j0 + window;
        uint32_t pa[BQ / 16][4], da[BQ / 16][4];
#pragma unroll
        for (int jb = 0; jb < NQ; ++jb) {
            float p[4], ds[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int col = 8 * jb + 2 * tq + (e & 1);
                const int j = j0 + gr + (e >> 1) * 8;
                p[e] = fast_exp2(fmaf(sT[jb][e], scale_log2, -sls[col]));
                if (!full && !attends(q0 + col, j, S, window)) p[e] = 0.f;
                ds[e] = p[e] * (dpT[jb][e] - sds[col]);
            }
            pa[jb >> 1][(jb & 1) * 2] = pack_bf16(p[0], p[1]);
            pa[jb >> 1][(jb & 1) * 2 + 1] = pack_bf16(p[2], p[3]);
            da[jb >> 1][(jb & 1) * 2] = pack_bf16(ds[0], ds[1]);
            da[jb >> 1][(jb & 1) * 2 + 1] = pack_bf16(ds[2], ds[3]);
        }
        const uint32_t qst = smem_addr(sqs + t_off), ost = smem_addr(sos + t_off);
#pragma unroll
        for (int kb2 = 0; kb2 < BQ / 16; ++kb2) {
#pragma unroll
            for (int db = 0; db < DA / 16; ++db) {
                if (c0 + db * 16 < D) {
                    uint32_t bo[4], bq[4];
                    ldsm_x4_trans(bo, ost + (kb2 * 16 * ld + c0 + db * 16) * 2);
                    ldsm_x4_trans(bq, qst + (kb2 * 16 * ld + c0 + db * 16) * 2);
                    mma_bf16(dva[2 * db], pa[kb2], bo[0], bo[1]);
                    mma_bf16(dva[2 * db + 1], pa[kb2], bo[2], bo[3]);
                    mma_bf16(dka[2 * db], da[kb2], bq[0], bq[1]);
                    mma_bf16(dka[2 * db + 1], da[kb2], bq[2], bq[3]);
                }
            }
        }
    }
    cp_async_wait<0>();

#pragma unroll
    for (int i = 0; i < 2; ++i) {
        const int j = j0 + gr + 8 * i;
        if (j >= S) continue;
        const int64_t off = (((int64_t)b * S + j) * Hkv + hk) * D;
#pragma unroll
        for (int db = 0; db < NA; ++db) {
            const int c = c0 + 8 * db + 2 * tq;
            if (c < D && c < c0 + DA) {
                *reinterpret_cast<uint32_t*>(dk + off + c) =
                    pack_bf16(dka[db][2 * i] * scale, dka[db][2 * i + 1] * scale);
                *reinterpret_cast<uint32_t*>(dv + off + c) =
                    pack_bf16(dva[db][2 * i], dva[db][2 * i + 1]);
            }
        }
    }
}

template <int DT, int DC>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_mma(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 __nv_bfloat16* __restrict__ dq, int S, int H, int Hkv, int D_run, int window,
                 float scale_log2, float scale) {
    const int D = DC > 0 ? DC : D_run;
    constexpr int QB = BwdTile<DT>::QB, KB = BwdTile<DT>::KB;
    constexpr int NK = KB / 8;                 // 8-key score blocks per kv tile
    constexpr int DB = DT / 8;                 // 8-column accumulator blocks
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int ld = row_elems(D);
    __nv_bfloat16* sq = reinterpret_cast<__nv_bfloat16*>(smem_raw);
    __nv_bfloat16* sdo = sq + QB * ld;
    __nv_bfloat16* sk = sdo + QB * ld;         // two stages of KB rows
    __nv_bfloat16* sv = sk + 2 * KB * ld;      // two stages of KB rows

    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int gr = lane >> 2, tq = lane & 3;
    const int q0 = (gridDim.x - 1 - blockIdx.x) * QB;      // longest rows first
    const int h = blockIdx.y, b = blockIdx.z;
    const int hk = h / (H / Hkv);
    const int64_t qstride = (int64_t)H * D, kstride = (int64_t)Hkv * D;
    const __nv_bfloat16* kb = k + ((int64_t)b * S * Hkv + hk) * D;
    const __nv_bfloat16* vb = v + ((int64_t)b * S * Hkv + hk) * D;

    const int lo = window > 0 ? max(0, q0 - window + 1) : 0;
    const int hi = min(S, q0 + QB);
    const int kt_lo = lo / KB, kt_hi = (hi - 1) / KB + 1;
    load_tile<QB>(sq, q + ((int64_t)b * S * H + h) * D, qstride, q0, S, D);
    load_tile<QB>(sdo, dout + ((int64_t)b * S * H + h) * D, qstride, q0, S, D);
    load_tile<KB>(sk, kb, kstride, kt_lo * KB, S, D);
    load_tile<KB>(sv, vb, kstride, kt_lo * KB, S, D);
    cp_async_commit();

    const int w0 = q0 + 16 * warp;            // the warp's first q row
    float l2[2], dl[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        const int r = w0 + gr + 8 * i;
        l2[i] = r < S ? lse[((int64_t)b * H + h) * S + r] * kLog2e : INFINITY;
        dl[i] = r < S ? delta[((int64_t)b * H + h) * S + r] : 0.f;
    }
    float dqa[DB][4];
#pragma unroll
    for (int j = 0; j < DB; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) dqa[j][e] = 0.f;

    const int a_off = (16 * warp + (lane & 15)) * ld + ((lane >> 4) << 3);
    const uint32_t q_a = smem_addr(sq + a_off), o_a = smem_addr(sdo + a_off);
    const int b_off = ((lane & 7) + ((lane >> 4) << 3)) * ld + (((lane >> 3) & 1) << 3);
    const int t_off = ((lane & 7) + (((lane >> 3) & 1) << 3)) * ld + ((lane >> 4) << 3);

    for (int kt = kt_lo; kt < kt_hi; ++kt) {
        const int st = (kt - kt_lo) & 1;
        cp_async_wait<0>();
        __syncthreads();                       // every warp is done with tile kt - 1
        if (kt + 1 < kt_hi) {
            load_tile<KB>(sk + (st ^ 1) * KB * ld, kb, kstride, (kt + 1) * KB, S, D);
            load_tile<KB>(sv + (st ^ 1) * KB * ld, vb, kstride, (kt + 1) * KB, S, D);
        }
        cp_async_commit();

        const int k0 = kt * KB;
        bool live = w0 < S && k0 <= w0 + 15;
        if (window > 0) live = live && k0 + KB - 1 > w0 - window;
        if (!live) continue;
        float s[NK][4], dp[NK][4];
#pragma unroll
        for (int j = 0; j < NK; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
        const uint32_t ksb = smem_addr(sk + st * KB * ld + b_off);
        const uint32_t vsb = smem_addr(sv + st * KB * ld + b_off);
#pragma unroll
        for (int kk = 0; kk < DT / 16; ++kk) {
            if (kk * 16 < D) {
                uint32_t aq[4], ao[4];
                ldsm_x4(aq, q_a + kk * 32);
                ldsm_x4(ao, o_a + kk * 32);
#pragma unroll
                for (int nb = 0; nb < KB / 16; ++nb) {
                    uint32_t bk[4], bv[4];
                    ldsm_x4(bk, ksb + (nb * 16 * ld + kk * 16) * 2);
                    ldsm_x4(bv, vsb + (nb * 16 * ld + kk * 16) * 2);
                    mma_bf16(s[2 * nb], aq, bk[0], bk[1]);
                    mma_bf16(s[2 * nb + 1], aq, bk[2], bk[3]);
                    mma_bf16(dp[2 * nb], ao, bv[0], bv[1]);
                    mma_bf16(dp[2 * nb + 1], ao, bv[2], bv[3]);
                }
            }
        }
        bool full = k0 + KB - 1 <= w0;
        if (window > 0) full = full && k0 > w0 + 15 - window;
        uint32_t da[KB / 16][4];
#pragma unroll
        for (int jb = 0; jb < NK; ++jb) {
            float ds[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int j = k0 + 8 * jb + 2 * tq + (e & 1);
                const int i = w0 + gr + (e >> 1) * 8;
                float p = fast_exp2(fmaf(s[jb][e], scale_log2, -l2[e >> 1]));
                if (!full && !attends(i, j, S, window)) p = 0.f;
                ds[e] = p * (dp[jb][e] - dl[e >> 1]);
            }
            da[jb >> 1][(jb & 1) * 2] = pack_bf16(ds[0], ds[1]);
            da[jb >> 1][(jb & 1) * 2 + 1] = pack_bf16(ds[2], ds[3]);
        }
        const uint32_t kst = smem_addr(sk + st * KB * ld + t_off);
#pragma unroll
        for (int kb2 = 0; kb2 < KB / 16; ++kb2) {
#pragma unroll
            for (int db = 0; db < DT / 16; ++db) {
                if (db * 16 < D) {
                    uint32_t bk[4];
                    ldsm_x4_trans(bk, kst + (kb2 * 16 * ld + db * 16) * 2);
                    mma_bf16(dqa[2 * db], da[kb2], bk[0], bk[1]);
                    mma_bf16(dqa[2 * db + 1], da[kb2], bk[2], bk[3]);
                }
            }
        }
    }
    cp_async_wait<0>();

#pragma unroll
    for (int i = 0; i < 2; ++i) {
        const int r = w0 + gr + 8 * i;
        if (r >= S) continue;
        __nv_bfloat16* row = dq + (((int64_t)b * S + r) * H + h) * D;
#pragma unroll
        for (int db = 0; db < DB; ++db) {
            const int c = 8 * db + 2 * tq;
            if (c < D)
                *reinterpret_cast<uint32_t*>(row + c) =
                    pack_bf16(dqa[db][2 * i] * scale, dqa[db][2 * i + 1] * scale);
        }
    }
}

template <int DT, int DC>
cudaError_t launch_bwd_dt(const void* q, const void* k, const void* v, const void* dout,
                          const float* lse, const float* delta, void* dq, void* dk, void* dv,
                          int B, int S, int H, int Hkv, int D, int window, cudaStream_t stream) {
    using BT = BwdTile<DT>;
    const int smem1 = dkdv_smem_bytes<DT>(D), smem2 = dq_smem_bytes<DT>(D);
    cudaError_t e = cudaFuncSetAttribute(flash_bwd_dkdv_mma<DT, DC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem1);
    if (e != cudaSuccess) return e;
    e = cudaFuncSetAttribute(flash_bwd_dq_mma<DT, DC>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem2);
    if (e != cudaSuccess) return e;
    const double log2e = 1.4426950408889634;
    const float scale = (float)(1.0 / sqrt((double)D)), scale_log2 = (float)(log2e / sqrt((double)D));
    const int nsplit = (D + BT::DA - 1) / BT::DA;
    const auto* q_ = static_cast<const __nv_bfloat16*>(q);
    const auto* k_ = static_cast<const __nv_bfloat16*>(k);
    const auto* v_ = static_cast<const __nv_bfloat16*>(v);
    const auto* do_ = static_cast<const __nv_bfloat16*>(dout);
    flash_bwd_dkdv_mma<DT, DC><<<dim3((S + BT::BK - 1) / BT::BK, Hkv * nsplit, B), kThreads,
                                 smem1, stream>>>(
        q_, k_, v_, do_, lse, delta, static_cast<__nv_bfloat16*>(dk),
        static_cast<__nv_bfloat16*>(dv), S, H, Hkv, D, window, scale_log2, scale);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    flash_bwd_dq_mma<DT, DC><<<dim3((S + BT::QB - 1) / BT::QB, H, B), kThreads, smem2,
                               stream>>>(
        q_, k_, v_, do_, lse, delta, static_cast<__nv_bfloat16*>(dq), S, H, Hkv, D, window,
        scale_log2, scale);
    return cudaGetLastError();
}

cudaError_t launch_bwd(const void* q, const void* k, const void* v, const void* dout,
                       const float* lse, const float* delta, void* dq, void* dk, void* dv, int B,
                       int S, int H, int Hkv, int D, int window, cudaStream_t stream) {
#define FA_TC_BWD(DT, DC) \
    launch_bwd_dt<DT, DC>(q, k, v, dout, lse, delta, dq, dk, dv, B, S, H, Hkv, D, window, stream)
    switch (D) {
        case 16: return FA_TC_BWD(32, 16);
        case 32: return FA_TC_BWD(32, 32);
        case 64: return FA_TC_BWD(64, 64);
        case 128: return FA_TC_BWD(128, 128);
        case 256: return FA_TC_BWD(256, 256);
        default: break;
    }
    if (D < 64) return FA_TC_BWD(64, 0);
    if (D < 128) return FA_TC_BWD(128, 0);
    return FA_TC_BWD(256, 0);
#undef FA_TC_BWD
}

}  // namespace tc

// ---------------------------------------------------------------------------
// Tensor-core backward for Hopper: bfloat16 at D = 64, 128 and 256
//
// Replaces no TPU kernel: the JAX package has no backward kernel (its train
// step differentiates the Pallas forward,
// src/repro/kernels/flash_attention/kernel.py:73, through XLA).  Same
// contract and roundings as the mma.sync backward above (P and dS rounded
// to bf16 before their products, every sum fp32, each output element
// written once after a fixed-order sum), in two launches on the stream:
//
// * dQ first: one block per (q tile of 64 x kDqWgs rows, head, batch row),
//   longest rows first.  Its consumer warpgroups (64 q rows each) first
//   form delta = rowsum(dO o) in fp32 for their rows from o and dO (one
//   warp a row, a fixed shuffle tree) and write it to the (B, H, S) delta
//   buffer, so no pre-pass reads o and dO again.  Q and dO stay in shared
//   memory; K and V tiles of 64 rows stream through a TMA ring.  Per tile
//   S = Q K^T and dP = dO V^T by wgmma (A = Q, dO; B = K, V, all K-major),
//   then P = exp2(S scale log2 e - lse log2 e) and dS = P (dP - delta) in
//   registers, and dQ += dS K with dS as wgmma's register A operand (the
//   accumulator re-packed as bf16 pairs, no shared-memory round trip) and
//   K read MN-major from the same swizzled tile.
// * dK/dV next: one block per (kv tile, kv head, batch row), K and V of the
//   tile stationary.  A producer warp streams, for every q tile and query
//   head of the group that sees those keys, the Q and dO tiles (TMA, 4-D
//   boxes over the (B, S, H, D) layout, 128-byte swizzle) with that tile's
//   lse and delta into an mbarrier ring.  Per item S^T = K Q^T and dP^T =
//   V dO^T (wgmma, both operands K-major in shared memory), P^T and dS^T in
//   registers, then dV += P^T dO and dK += dS^T Q with P^T and dS^T as the
//   register A operand and dO, Q read MN-major (the transpose bit) from the
//   tiles the first two products read K-major.  GQA's sum over the group
//   is the block's walk, so nothing is added atomically.  At D <= 128 two
//   consumer warpgroups own 64 kv rows each (128 a block) and share every
//   streamed tile.  At D = 256 a warpgroup's dK and dV of 64 rows would
//   need 256 fp32 registers a thread, so both warpgroups own the same 64
//   rows and 128 columns each: warpgroup 0 forms S^T and P^T, warpgroup 1
//   dP^T and dS^T, and they hand P^T (fp32) and dS^T (bf16 pairs) to each
//   other through shared memory at two named barriers, so S^T and dP^T are
//   computed once a tile, not once per column half.
//
// Block shape: consumer warpgroups first, then one producer warpgroup of
// which one warp works (setmaxnreg: 240 registers a consumer thread, 24 a
// producer thread).  The grid puts the row blocks on its slowest axis, so
// every head's longest walks start first.  A warpgroup runs the wgmmas
// only on the items that hold one of its attended pairs: the items before
// and after that range it waits for and releases, so no branch steers a
// wgmma.  The mask (one unsigned compare of i - j against the window) is
// applied only on tiles that cross its edge for one of a warp's rows.
// Where the registers allow (dQ at D <= 128, dK/dV at D = 64) the loop is
// software-pipelined: S and dP of the next tile are issued with the
// products of this one, so a warpgroup's exponentials overlap its own
// tensor-core work; at D = 64 the stationary operands (Q and dO, or K and
// V) are also held as register A operands, which halves the shared-memory
// reads of the score products.  Registers that a wgmma reads are written
// only while none is in flight, so ptxas serialises no wgmma (no C751x
// warning; chip_smoke.py checks the build log).
// kernels/flash_attention/plan.py models both walks for the CPU tests.
//
// Bound on the H100 (989 TFLOP/s dense bf16; 3.35 TB/s): 10 D operations
// per (query head, attended pair), the five products, or the bytes of
// q, k, v, o, dO, lse in and dq, dk, dv out (chip_smoke.py's
// flash_bwd_bound); at every training shape the operations bound.  This
// design does 14 D a pair (S and dP once in each kernel).  Against the
// mma.sync design: (1) no recompute across column halves at D = 256 (14
// D, not 18 D) and none of delta; (2) wgmma from 64-row warpgroup tiles
// with B read from shared memory by the tensor cores and A of the second
// products from registers, where mma.sync re-read both operands by
// ldmatrix every k step; (3) TMA copies issued by one thread into a ring
// of 2-4 stages, so loads of the next item overlap this item's products;
// (4) no third launch: delta is formed in the dQ kernel.

namespace wg {

using namespace hopper;

constexpr int kTile = 64;          // q rows of a dK/dV item, kv rows of a dQ step, wgmma M
constexpr int kBox = 64 * 128;     // one TMA box: 64 rows x 64 columns of bf16
constexpr int kConsumerRegs = 240;
constexpr int kProducerRegs = 24;

template <int D>
struct Cfg {
    static_assert(D == 64 || D == 128 || D == 256, "the wgmma backward takes D 64, 128, 256");
    static constexpr int kCols = D > 128 ? 128 : D;       // columns of one accumulator
    // dK/dV: two consumer warpgroups; at D = 256 over the same 64 rows
    static constexpr bool kSplit = D > 128;
    static constexpr int kKvRows = kSplit ? 64 : 128;
    // rings as deep as shared memory allows where the loop is pipelined
    // (dQ at D <= 128, dK/dV at D = 64): it holds two stages at once (tile
    // n's product, tile n + 1's scores), and at D = 64 six stages ran
    // faster than four on the card
    static constexpr int kKvStages = D > 128 ? 2 : (D > 64 ? 3 : 6);
    // dQ: 64 q rows a consumer warpgroup
    static constexpr int kDqWgs = D > 128 ? 1 : 2;
    static constexpr int kQRows = 64 * kDqWgs;
    static constexpr int kQStages = D > 128 ? 2 : (D > 64 ? 5 : 6);
    static constexpr int kTileBytes = kTile * D * 2;      // one 64-row tile of Q, dO, K or V
    static constexpr int kXp = kSplit ? kTile * kTile * 4 : 0;      // P^T handed over, fp32
    static constexpr int kXds = kSplit ? 128 * 16 * 4 : 0;          // dS^T handed over, bf16
    static constexpr int kv_smem() {
        return 1024 + 2 * kKvRows * D * 2 + kKvStages * 2 * kTileBytes +
               kKvStages * kTile * 8 + kXp + kXds + (2 * kKvStages + 1) * 8;
    }
    static constexpr int q_smem() {
        return 1024 + 2 * kQRows * D * 2 + kQStages * 2 * kTileBytes + kQRows * 4 +
               (2 * kQStages + 1) * 8;
    }
};

struct Params {
    CUtensorMap q, k, v, dout;          // (D, heads, S, B), box 64 x 1 x 64 x 1
    const __nv_bfloat16* o;             // (B, S, H, D)
    const __nv_bfloat16* dout_ptr;
    const float* lse;                   // (B, H, S)
    float* delta;                       // (B, H, S)
    __nv_bfloat16 *dq, *dk, *dv;
    int S, H, Hkv, window;
    float scale, scale_log2;
};

__device__ __forceinline__ uint64_t kmajor(uint32_t addr) { return sw128_desc(addr, 16, 1024); }

// B (16 rows of k x N columns) from rows [16 kk, 16 kk + 16) of a tile of
// `rows` rows read MN-major, from its 64-column box c0 on
__device__ __forceinline__ uint64_t mnmajor(uint32_t tile, int rows, int c0, int kk) {
    return sw128_desc(tile + c0 * rows * 128 + kk * 2048, rows * 128, 1024);
}

template <int NC>
__device__ __forceinline__ void mma_rs(float (&acc)[NC / 2], const uint32_t (&a)[4], uint64_t b) {
    if constexpr (NC == 64)
        wgmma_m64n64k16_rs<1>(acc, a, b);
    else
        wgmma_m64n128k16_rs<1>(acc, a, b);
}

template <int N>
__device__ __forceinline__ void fence_frags(uint32_t (&a)[4][N]) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < N; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

// acc (64 x 64) = rows of A (64 rows from `a`, K-major, boxes `a_rows`
// rows apart) . rows of B (`b`, 64 rows, K-major) over D
template <int D>
__device__ __forceinline__ void mma_ss_rows(float (&acc)[32], uint32_t a, int a_rows, uint32_t b) {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
        wgmma_m64n64k16_ss<0>(acc, kmajor(a + (kk >> 2) * a_rows * 128 + (kk & 3) * 32),
                              kmajor(b + (kk >> 2) * kBox + (kk & 3) * 32), kk);
}

// The A fragments (k steps over D) of the 64 rows at `a` (K-major, boxes
// `a_rows` rows apart, 128-byte swizzle) by ldmatrix: warp w's 16 rows, in
// the layout wgmma's register A operand takes.
template <int D>
__device__ __forceinline__ void load_frags(uint32_t (&f)[D / 16][4], uint32_t a, int a_rows) {
    const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
    const int r = 16 * warp + (lane & 7) + 8 * ((lane >> 3) & 1);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
        const int chunk = 2 * (kk & 3) + (lane >> 4);
        tc::ldsm_x4(f[kk], a + (kk >> 2) * a_rows * 128 + r * 128 + ((chunk ^ (lane & 7)) << 4));
    }
}

// acc (64 x 64) = A (64 x D, register fragments) . rows of B (`b`, 64
// rows, K-major) over D
template <int D>
__device__ __forceinline__ void mma_rs_rows(float (&acc)[32], const uint32_t (&f)[D / 16][4],
                                            uint32_t b) {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
        wgmma_m64n64k16_rs<0>(acc, f[kk], kmajor(b + (kk >> 2) * kBox + (kk & 3) * 32), kk);
}

// the 64 x 64 score block's accumulator as bf16 A fragments (k steps over its columns)
__device__ __forceinline__ void to_frags(uint32_t (&f)[4][4], const float (&x)[32]) {
#pragma unroll
    for (int nb = 0; nb < 8; ++nb) {
        f[nb >> 1][(nb & 1) * 2] = tc::pack_bf16(x[4 * nb], x[4 * nb + 1]);
        f[nb >> 1][(nb & 1) * 2 + 1] = tc::pack_bf16(x[4 * nb + 2], x[4 * nb + 3]);
    }
}

// rows [r0, r0 + 64 n) of one head into `dst` (64-column boxes of 64 n rows)
template <int D>
__device__ __forceinline__ void tma_rows(unsigned char* dst, const CUtensorMap* map,
                                         uint64_t* bar, int head, int r0, int n, int b) {
#pragma unroll
    for (int c = 0; c < D / 64; ++c)
        for (int r = 0; r < n; ++r)
            tma_load_4d(dst + (c * n + r) * kBox, map, bar, 64 * c, head, r0 + 64 * r, b);
}

// Store one 64 x NC accumulator (fp32) times `mul` as bf16 rows of a
// (rows, heads, D) tensor at row stride `stride`: rows r0 + 16 warp + gr (+
// 8) below `limit`, columns c0 + 8 c + 2 tq (+ 1).
template <int NC>
__device__ __forceinline__ void store_rows(__nv_bfloat16* out, int64_t stride,
                                           const float (&acc)[NC / 2], int r0, int limit,
                                           int c0, float mul) {
    const int t = threadIdx.x & 127, warp = t >> 5, lane = t & 31;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
        const int r = r0 + 16 * warp + (lane >> 2) + 8 * half;
        if (r >= limit) continue;
        __nv_bfloat16* row = out + (int64_t)r * stride + c0 + 2 * (lane & 3);
#pragma unroll
        for (int c = 0; c < NC / 8; ++c)
            *reinterpret_cast<uint32_t*>(row + 8 * c) =
                tc::pack_bf16(acc[4 * c + 2 * half] * mul, acc[4 * c + 2 * half + 1] * mul);
    }
}

// -- dQ (and delta) ----------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(384, 1)     // 256 threads at D = 256: the same entry count
flash_bwd_dq_wgmma(const __grid_constant__ Params p) {
    using C = Cfg<D>;
    constexpr int NW = C::kDqWgs, QR = C::kQRows, NS = C::kQStages, NC = C::kCols;
    constexpr bool kPipe = NS >= 3;
    // Q and dO as register A operands (64 registers), in the pipelined loop
    // only: the plain loop with them gave wrong gradients on the card
    // (PERF.md §7)
    constexpr bool kRegA = kPipe && D == 64;
    constexpr int kQBytes = QR * D * 2;
    constexpr int kStage = 2 * C::kTileBytes;
    extern __shared__ unsigned char smem_raw[];
    unsigned char* sq = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
    unsigned char* sdo = sq + kQBytes;
    unsigned char* ring = sdo + kQBytes;          // NS stages of a K tile, then a V tile
    float* sdelta = reinterpret_cast<float*>(ring + NS * kStage);
    uint64_t* full = reinterpret_cast<uint64_t*>(sdelta + QR);
    uint64_t* empty = full + NS;
    uint64_t* qbar = empty + NS;

    const int S = p.S, H = p.H, window = p.window;
    // row blocks on the grid's slowest axis, longest rows first, so every
    // head's longest blocks start before any shorter one
    const int q0 = (gridDim.z - 1 - blockIdx.z) * QR;
    const int h = blockIdx.x, b = blockIdx.y;
    const int hk = h / (H / p.Hkv);
    // kv tiles that hold a key some row of [q0, q_hi] attends
    const int q_hi = min(q0 + QR, S) - 1;
    const int kt_lo = (window > 0 ? max(0, q0 - window + 1) : 0) / kTile;
    const int n_tiles = q_hi / kTile + 1 - kt_lo;

    if (threadIdx.x == 0) {
        for (int s = 0; s < NS; ++s) {
            mbar_init(&full[s], 1);
            mbar_init(&empty[s], 4 * NW);       // lane 0 of every consumer warp
        }
        mbar_init(qbar, 1);
        mbar_fence_init();
    }
    __syncthreads();

    const int wg = threadIdx.x >> 7;
    if (wg == NW) {
        reg_dealloc<kProducerRegs>();
        if (threadIdx.x != 128 * NW) return;
        mbar_arrive_expect_tx(qbar, 2 * kQBytes);
        tma_rows<D>(sq, &p.q, qbar, h, q0, NW, b);
        tma_rows<D>(sdo, &p.dout, qbar, h, q0, NW, b);
        int s = 0;
        uint32_t phase = 0;
        for (int n = 0; n < n_tiles; ++n) {
            mbar_wait(&empty[s], phase ^ 1);
            unsigned char* st = ring + s * kStage;
            mbar_arrive_expect_tx(&full[s], kStage);
            tma_rows<D>(st, &p.k, &full[s], hk, (kt_lo + n) * kTile, 1, b);
            tma_rows<D>(st + C::kTileBytes, &p.v, &full[s], hk, (kt_lo + n) * kTile, 1, b);
            if (++s == NS) {
                s = 0;
                phase ^= 1;
            }
        }
    } else {
        reg_alloc<kConsumerRegs>();
        const int t = threadIdx.x & 127, warp = t >> 5, lane = t & 31;
        const int gr = lane >> 2, tq = lane & 3;
        const int cwg = uniform(wg);
        const int w0 = q0 + 64 * cwg;                     // the warpgroup's first q row
        const int iw = w0 + 16 * warp;                    // the warp's first q row
        // delta = rowsum(dO o) in fp32 for the warp's 16 rows: lane l sums
        // its pairs 2 (l + 32 e), then a fixed shuffle tree; the loads of
        // RB rows are issued together (rows past S read row S - 1, unused)
        constexpr int RB = 16 * 64 / D;
#pragma unroll
        for (int r0 = 0; r0 < 16; r0 += RB) {
            __nv_bfloat162 ov[RB][D / 64], gv[RB][D / 64];
#pragma unroll
            for (int rr = 0; rr < RB; ++rr) {
                const int i = min(iw + r0 + rr, S - 1);
                const int64_t off = (((int64_t)b * S + i) * H + h) * D;
                const __nv_bfloat162* orow = reinterpret_cast<const __nv_bfloat162*>(p.o + off);
                const __nv_bfloat162* drow =
                    reinterpret_cast<const __nv_bfloat162*>(p.dout_ptr + off);
#pragma unroll
                for (int e = 0; e < D / 64; ++e) {
                    ov[rr][e] = orow[lane + 32 * e];
                    gv[rr][e] = drow[lane + 32 * e];
                }
            }
#pragma unroll
            for (int rr = 0; rr < RB; ++rr) {
                const int i = iw + r0 + rr;
                float acc = 0.f;
#pragma unroll
                for (int e = 0; e < D / 64; ++e) {
                    const float2 o2 = __bfloat1622float2(ov[rr][e]);
                    const float2 g2 = __bfloat1622float2(gv[rr][e]);
                    acc = fmaf(g2.x, o2.x, acc);
                    acc = fmaf(g2.y, o2.y, acc);
                }
#pragma unroll
                for (int off = 16; off > 0; off >>= 1)
                    acc += __shfl_xor_sync(0xffffffffu, acc, off);
                if (i >= S) acc = 0.f;
                if (lane == 0) {
                    sdelta[64 * cwg + 16 * warp + r0 + rr] = acc;
                    if (i < S) p.delta[((int64_t)b * H + h) * S + i] = acc;
                }
            }
        }
        __syncwarp();
        float nl2[2], dl[2];              // -lse log2 e (-inf past S) and delta of two rows
#pragma unroll
        for (int e = 0; e < 2; ++e) {
            const int i = iw + gr + 8 * e;
            nl2[e] = i < S ? -p.lse[((int64_t)b * H + h) * S + i] * kLog2e : -INFINITY;
            dl[e] = sdelta[64 * cwg + 16 * warp + gr + 8 * e];
        }
        const unsigned wlim = window > 0 ? (unsigned)window : 0x7fffffffu;
        float dq[D / NC][NC / 2];
#pragma unroll
        for (int c = 0; c < D / NC; ++c)
#pragma unroll
            for (int e = 0; e < NC / 2; ++e) dq[c][e] = 0.f;

        // the warpgroup's live tiles [a, z) of the walk
        const int i_hi = min(w0 + 63, S - 1);
        int a = 0, z = 0;
        if (w0 < S) {
            const int lo = window > 0 ? max(0, w0 - window + 1) : 0;
            a = max(lo / kTile - kt_lo, 0);
            z = min(i_hi / kTile + 1 - kt_lo, n_tiles);
        }
        a = uniform(a);
        z = uniform(max(a, z));
        const int nt = uniform(n_tiles);
        const uint32_t qa = smem_u32(sq) + cwg * kBox, oa = smem_u32(sdo) + cwg * kBox;
        // tile n of the walk sits in stage n % NS, in its (n / NS)-th fill
        auto wait_full = [&](int n) { mbar_wait(&full[n % NS], (n / NS) & 1); };
        auto release = [&](int n) { mbar_arrive_if(&empty[n % NS], lane == 0); };
        auto stage = [&](int n) { return smem_u32(ring + (n % NS) * kStage); };
        float sc[32], dp[32];
        uint32_t qf[kRegA ? D / 16 : 1][4], of[kRegA ? D / 16 : 1][4];
        // S = Q K^T and dP = dO V^T of tile n, one commit group
        auto issue_sp = [&](int n) {
            wgmma_fence();
            if constexpr (kRegA) {
                mma_rs_rows<D>(sc, qf, stage(n));
                mma_rs_rows<D>(dp, of, stage(n) + C::kTileBytes);
            } else {
                mma_ss_rows<D>(sc, qa, QR, stage(n));
                mma_ss_rows<D>(dp, oa, QR, stage(n) + C::kTileBytes);
            }
            wgmma_commit();
        };
        // dS = P (dP - delta), P = exp2(S scale log2 e - lse log2 e) where row
        // i attends key j (d = i - j in [0, window)), fp32 in place of S; the
        // mask only on tiles that cross its edge for one of the warp's rows
        auto grad_scores = [&](int n) {
            fence_operands(sc);
            fence_operands(dp);
            const int k0 = (kt_lo + n) * kTile;
            const int dlt = iw + gr - k0 - 2 * tq;
            auto run = [&](auto masked) {
#pragma unroll
                for (int nb = 0; nb < 8; ++nb)
#pragma unroll
                    for (int e = 0; e < 4; ++e) {
                        float pv = tc::fast_exp2(fmaf(sc[4 * nb + e], p.scale_log2, nl2[e >> 1]));
                        if constexpr (decltype(masked)::value) {
                            const int d = dlt + 8 * (e >> 1) - 8 * nb - (e & 1);
                            pv = (unsigned)d < wlim ? pv : 0.f;
                        }
                        sc[4 * nb + e] = pv * (dp[4 * nb + e] - dl[e >> 1]);
                    }
            };
            if (iw - k0 - (kTile - 1) >= 0 && (unsigned)(iw + 15 - k0) < wlim)
                run(std::false_type{});
            else
                run(std::true_type{});
        };
        // dQ += dS K of tile n, one commit group
        auto issue_dq = [&](int n, uint32_t (&da)[4][4]) {
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < 4; ++kk)
#pragma unroll
                for (int c = 0; c < D / NC; ++c)
                    mma_rs<NC>(dq[c], da[kk], mnmajor(stage(n), kTile, c * (NC / 64), kk));
            wgmma_commit();
        };
        mbar_wait(qbar, 0);
        if constexpr (kRegA) {
            load_frags<D>(qf, qa, QR);
            load_frags<D>(of, oa, QR);
        }
        for (int n = 0; n < a; ++n) {
            wait_full(n);
            release(n);
        }
        uint32_t da[4][4];
        if constexpr (kPipe) {
            // Software-pipelined: S and dP of tile n + 1 are issued with dQ
            // of tile n, and tile n + 1's exponentials and dS run while the
            // tensor cores finish dQ(n).  Registers that a wgmma reads are
            // written only while none is in flight (after wait<0>: the bf16
            // fragments) or when the next wgmma reading them comes after the
            // next wait<0> (S in place), so ptxas keeps the wgmmas
            // asynchronous.
            if (a < z) {
                wait_full(a);
                issue_sp(a);
                wgmma_wait<0>();
                grad_scores(a);
                to_frags(da, sc);
                for (int n = a; n + 1 < z; ++n) {
                    wait_full(n + 1);
                    issue_sp(n + 1);
                    issue_dq(n, da);
                    wgmma_wait<1>();              // S/dP(n + 1) done, dQ(n) may run
                    grad_scores(n + 1);
                    wgmma_wait<0>();
                    fence_frags(da);
                    release(n);
                    to_frags(da, sc);
                }
                issue_dq(z - 1, da);
                wgmma_wait<0>();
                release(z - 1);
            }
        } else {
            for (int n = a; n < z; ++n) {
                wait_full(n);
                issue_sp(n);
                wgmma_wait<0>();
                grad_scores(n);
                to_frags(da, sc);
                issue_dq(n, da);
                wgmma_wait<0>();
                fence_frags(da);
                release(n);
            }
        }
        fence_frags(da);
#pragma unroll
        for (int c = 0; c < D / NC; ++c) fence_operands(dq[c]);
        for (int n = z; n < nt; ++n) {
            wait_full(n);
            release(n);
        }

        __nv_bfloat16* out = p.dq + ((int64_t)b * S * H + h) * D;
#pragma unroll
        for (int c = 0; c < D / NC; ++c)
            store_rows<NC>(out, (int64_t)H * D, dq[c], w0, S, c * NC, p.scale);
    }
}

// -- dK and dV ----------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(384, 1)
flash_bwd_dkdv_wgmma(const __grid_constant__ Params p) {
    using C = Cfg<D>;
    constexpr int KR = C::kKvRows, NS = C::kKvStages, NC = C::kCols;
    constexpr bool kSplit = C::kSplit;
    constexpr bool kPipe = D == 64;       // fits the registers at D = 64 only
    constexpr bool kRegA = kPipe;         // K and V as register A operands, as in the dQ kernel
    constexpr int kKvBytes = KR * D * 2;
    constexpr int kStage = 2 * C::kTileBytes;
    extern __shared__ unsigned char smem_raw[];
    unsigned char* sk = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
    unsigned char* sv = sk + kKvBytes;
    unsigned char* ring = sv + kKvBytes;          // NS stages of a Q tile, then a dO tile
    float* sl = reinterpret_cast<float*>(ring + NS * kStage);     // NS x 64: -lse log2 e
    float* sdl = sl + NS * kTile;                                  // NS x 64: delta
    float* xp = sdl + NS * kTile;                                  // split: P^T, fragment order
    uint32_t* xds = reinterpret_cast<uint32_t*>(reinterpret_cast<unsigned char*>(xp) + C::kXp);
    uint64_t* full = reinterpret_cast<uint64_t*>(reinterpret_cast<unsigned char*>(xds) + C::kXds);
    uint64_t* empty = full + NS;
    uint64_t* kvbar = empty + NS;

    const int S = p.S, H = p.H, window = p.window;
    const int G = H / p.Hkv;
    // kv blocks on the grid's slowest axis: the first (longest causal walk) first
    const int k0 = blockIdx.z * KR, hk = blockIdx.x, b = blockIdx.y;
    // q tiles that hold a row attending some key of [k0, k_hi]; items are
    // (q tile, query head of the group), the heads innermost
    const int k_hi = min(k0 + KR, S) - 1;
    const int q_last = window > 0 ? min(S - 1, k_hi + window - 1) : S - 1;
    const int qt_lo = k0 / kTile;
    const int n_items = (q_last / kTile + 1 - qt_lo) * G;

    if (threadIdx.x == 0) {
        for (int s = 0; s < NS; ++s) {
            mbar_init(&full[s], 1 + 32);         // the TMA's expect_tx, the warp's lse/delta
            mbar_init(&empty[s], 8);             // lane 0 of every consumer warp
        }
        mbar_init(kvbar, 1);
        mbar_fence_init();
    }
    __syncthreads();

    const int wg = threadIdx.x >> 7;
    if (wg == 2) {
        reg_dealloc<kProducerRegs>();
        if (threadIdx.x >= 256 + 32) return;
        const int lane = threadIdx.x & 31;
        if (lane == 0) {
            mbar_arrive_expect_tx(kvbar, 2 * kKvBytes);
            tma_rows<D>(sk, &p.k, kvbar, hk, k0, KR / 64, b);
            tma_rows<D>(sv, &p.v, kvbar, hk, k0, KR / 64, b);
        }
        int s = 0;
        uint32_t phase = 0;
        for (int n = 0; n < n_items; ++n) {
            const int q0 = (qt_lo + n / G) * kTile, h = hk * G + n % G;
            mbar_wait(&empty[s], phase ^ 1);
            unsigned char* st = ring + s * kStage;
            if (lane == 0) {
                mbar_arrive_expect_tx(&full[s], kStage);
                tma_rows<D>(st, &p.q, &full[s], h, q0, 1, b);
                tma_rows<D>(st + C::kTileBytes, &p.dout, &full[s], h, q0, 1, b);
            }
            const float* lrow = p.lse + ((int64_t)b * H + h) * S;
            const float* drow = p.delta + ((int64_t)b * H + h) * S;
            for (int r = lane; r < kTile; r += 32) {
                const int i = q0 + r;
                sl[s * kTile + r] = i < S ? -lrow[i] * kLog2e : -INFINITY;
                sdl[s * kTile + r] = i < S ? drow[i] : 0.f;
            }
            mbar_arrive_if(&full[s], true);
            if (++s == NS) {
                s = 0;
                phase ^= 1;
            }
        }
    } else {
        reg_alloc<kConsumerRegs>();
        const int t = threadIdx.x & 127, warp = t >> 5, lane = t & 31;
        const int gr = lane >> 2, tq = lane & 3;
        const int cwg = uniform(wg);
        const int rw = kSplit ? 0 : cwg;                  // the warpgroup's 64-row block of kv
        const int j0 = k0 + 64 * rw;
        const int jw = j0 + 16 * warp;                    // the warp's first kv row
        float dk[NC / 2], dv[NC / 2];
#pragma unroll
        for (int e = 0; e < NC / 2; ++e) dk[e] = dv[e] = 0.f;

        // the warpgroup's live items [a, z): the q tiles meeting its keys
        const int j_hi = min(j0 + 63, S - 1);
        int a = 0, z = 0;
        if (j0 < S) {
            const int top = window > 0 ? min(S - 1, j_hi + window - 1) : S - 1;
            a = (max(j0 / kTile, qt_lo) - qt_lo) * G;
            z = min((top / kTile + 1 - qt_lo) * G, n_items);
        }
        a = uniform(a);
        z = uniform(max(a, z));
        const int ni = uniform(n_items);
        const uint32_t ka = smem_u32(sk) + rw * kBox, va = smem_u32(sv) + rw * kBox;
        const unsigned wlim = window > 0 ? (unsigned)window : 0x7fffffffu;
        // item n of the walk sits in stage n % NS, in its (n / NS)-th fill
        auto wait_full = [&](int n) { mbar_wait(&full[n % NS], (n / NS) & 1); };
        auto release = [&](int n) { mbar_arrive_if(&empty[n % NS], lane == 0); };
        auto stage = [&](int n) { return smem_u32(ring + (n % NS) * kStage); };
        // element e of score block nb of item n pairs q row i and kv row j
        // at i - j = dlt(n) + 8 nb + (e & 1) - 8 (e >> 1); attended where
        // that lies in [0, window)
        auto dlt = [&](int n) { return (qt_lo + n / G) * kTile + 2 * tq - jw - gr; };
        const int c0 = kSplit ? 2 * cwg : 0;
        // dV += P^T dO and dK += dS^T Q over the warpgroup's columns, one group
        auto issue_dkdv = [&](int n, uint32_t (&pa)[4][4], uint32_t (&da)[4][4]) {
            const uint32_t qs = stage(n), os = qs + C::kTileBytes;
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) {
                mma_rs<NC>(dv, pa[kk], mnmajor(os, kTile, c0, kk));
                mma_rs<NC>(dk, da[kk], mnmajor(qs, kTile, c0, kk));
            }
            wgmma_commit();
        };
        mbar_wait(kvbar, 0);
        for (int n = 0; n < a; ++n) {
            wait_full(n);
            release(n);
        }
        uint32_t pa[4][4], da[4][4];
        if constexpr (!kSplit) {
            float st[32], dpt[32];
            uint32_t kf[kRegA ? D / 16 : 1][4], vf[kRegA ? D / 16 : 1][4];
            if constexpr (kRegA) {
                load_frags<D>(kf, ka, KR);
                load_frags<D>(vf, va, KR);
            }
            // S^T = K Q^T and dP^T = V dO^T of item n, one commit group
            auto issue_sp = [&](int n) {
                wgmma_fence();
                if constexpr (kRegA) {
                    mma_rs_rows<D>(st, kf, stage(n));
                    mma_rs_rows<D>(dpt, vf, stage(n) + C::kTileBytes);
                } else {
                    mma_ss_rows<D>(st, ka, KR, stage(n));
                    mma_ss_rows<D>(dpt, va, KR, stage(n) + C::kTileBytes);
                }
                wgmma_commit();
            };
            // P^T and dS^T = P^T (dP^T - delta), fp32 in place; the mask
            // only on items that cross its edge for one of the warp's rows
            auto grad_scores = [&](int n) {
                fence_operands(st);
                fence_operands(dpt);
                const float* ls = sl + (n % NS) * kTile;
                const float* ds = sdl + (n % NS) * kTile;
                const int d0 = dlt(n);
                auto run = [&](auto masked) {
#pragma unroll
                    for (int nb = 0; nb < 8; ++nb) {
                        const int col = 8 * nb + 2 * tq;
                        const float2 l2 = *reinterpret_cast<const float2*>(ls + col);
                        const float2 d2 = *reinterpret_cast<const float2*>(ds + col);
#pragma unroll
                        for (int e = 0; e < 4; ++e) {
                            float pv = tc::fast_exp2(fmaf(st[4 * nb + e], p.scale_log2,
                                                          (e & 1) ? l2.y : l2.x));
                            if constexpr (decltype(masked)::value) {
                                const int d = d0 + 8 * nb + (e & 1) - 8 * (e >> 1);
                                pv = (unsigned)d < wlim ? pv : 0.f;
                            }
                            st[4 * nb + e] = pv;
                            dpt[4 * nb + e] = pv * (dpt[4 * nb + e] - ((e & 1) ? d2.y : d2.x));
                        }
                    }
                };
                const int q0 = (qt_lo + n / G) * kTile;
                if (q0 - jw - 15 >= 0 && (unsigned)(q0 + kTile - 1 - jw) < wlim)
                    run(std::false_type{});
                else
                    run(std::true_type{});
            };
            if constexpr (kPipe) {
                // software-pipelined as the dQ kernel's loop: S^T/dP^T of
                // item n + 1 are issued with dV/dK of item n
                if (a < z) {
                    wait_full(a);
                    issue_sp(a);
                    wgmma_wait<0>();
                    grad_scores(a);
                    to_frags(pa, st);
                    to_frags(da, dpt);
                    for (int n = a; n + 1 < z; ++n) {
                        wait_full(n + 1);
                        issue_sp(n + 1);
                        issue_dkdv(n, pa, da);
                        wgmma_wait<1>();
                        grad_scores(n + 1);
                        wgmma_wait<0>();
                        fence_frags(pa);
                        fence_frags(da);
                        release(n);
                        to_frags(pa, st);
                        to_frags(da, dpt);
                    }
                    issue_dkdv(z - 1, pa, da);
                    wgmma_wait<0>();
                    release(z - 1);
                }
            } else {
                for (int n = a; n < z; ++n) {
                    wait_full(n);
                    issue_sp(n);
                    wgmma_wait<0>();
                    grad_scores(n);
                    to_frags(pa, st);
                    to_frags(da, dpt);
                    issue_dkdv(n, pa, da);
                    wgmma_wait<0>();
                    fence_frags(pa);
                    fence_frags(da);
                    release(n);
                }
            }
        } else {
            // warpgroup 0: S^T and P^T; warpgroup 1: dP^T and dS^T
            float2* xpf = reinterpret_cast<float2*>(xp);
            for (int n = a; n < z; ++n) {
                wait_full(n);
                const uint32_t qs = stage(n), os = qs + C::kTileBytes;
                float acc[32];
                wgmma_fence();
                mma_ss_rows<D>(acc, cwg == 0 ? ka : va, KR, cwg == 0 ? qs : os);
                wgmma_commit();
                wgmma_wait<0>();
                fence_operands(acc);
                if (cwg == 0) {
                    const float* ls = sl + (n % NS) * kTile;
                    const int d0 = dlt(n);
#pragma unroll
                    for (int nb = 0; nb < 8; ++nb) {
                        const float2 l2 = *reinterpret_cast<const float2*>(ls + 8 * nb + 2 * tq);
#pragma unroll
                        for (int e = 0; e < 4; ++e) {
                            const int d = d0 + 8 * nb + (e & 1) - 8 * (e >> 1);
                            acc[4 * nb + e] = (unsigned)d < wlim
                                                  ? tc::fast_exp2(fmaf(acc[4 * nb + e],
                                                                       p.scale_log2,
                                                                       (e & 1) ? l2.y : l2.x))
                                                  : 0.f;
                        }
                    }
#pragma unroll
                    for (int v = 0; v < 16; ++v)
                        xpf[v * 128 + t] = make_float2(acc[2 * v], acc[2 * v + 1]);
                }
                named_bar_sync(1, 256);                   // P^T handed over
                if (cwg == 1) {
                    const float* ds = sdl + (n % NS) * kTile;
                    float pt[32];
#pragma unroll
                    for (int v = 0; v < 16; ++v) {
                        const float2 pv = xpf[v * 128 + t];
                        pt[2 * v] = pv.x;
                        pt[2 * v + 1] = pv.y;
                    }
#pragma unroll
                    for (int nb = 0; nb < 8; ++nb) {
                        const float2 d2 = *reinterpret_cast<const float2*>(ds + 8 * nb + 2 * tq);
#pragma unroll
                        for (int e = 0; e < 4; ++e)
                            acc[4 * nb + e] = pt[4 * nb + e] *
                                              (acc[4 * nb + e] - ((e & 1) ? d2.y : d2.x));
                    }
                    to_frags(pa, pt);
                    to_frags(da, acc);
#pragma unroll
                    for (int v = 0; v < 16; ++v) xds[v * 128 + t] = da[v >> 2][v & 3];
                } else {
                    to_frags(pa, acc);
                }
                named_bar_sync(2, 256);                   // dS^T handed over
                if (cwg == 0) {
#pragma unroll
                    for (int v = 0; v < 16; ++v) da[v >> 2][v & 3] = xds[v * 128 + t];
                }
                issue_dkdv(n, pa, da);
                wgmma_wait<0>();
                fence_frags(pa);
                fence_frags(da);
                release(n);
            }
        }
        fence_frags(pa);
        fence_frags(da);
        fence_operands(dv);
        fence_operands(dk);
        for (int n = z; n < ni; ++n) {
            wait_full(n);
            release(n);
        }

        const int64_t stride = (int64_t)p.Hkv * D;
        const int64_t base = ((int64_t)b * S * p.Hkv + hk) * D;
        const int cc = kSplit ? NC * cwg : 0;
        store_rows<NC>(p.dk + base, stride, dk, j0, S, cc, p.scale);
        store_rows<NC>(p.dv + base, stride, dv, j0, S, cc, 1.f);
    }
}

// (D, heads, S, B) map of a (B, S, heads, D) bf16 tensor, box 64 x 1 x 64 x 1
inline bool encode_heads(CUtensorMap* map, const void* x, int B, int S, int heads, int D) {
    const uint64_t dims[4] = {(uint64_t)D, (uint64_t)heads, (uint64_t)S, (uint64_t)B};
    const uint64_t strides[3] = {(uint64_t)D * 2, (uint64_t)heads * D * 2,
                                 (uint64_t)S * heads * D * 2};
    const uint32_t box[4] = {64, 1, kTile, 1};
    return encode_bf16_sw128(map, x, 4, dims, strides, box);
}

template <int D>
cudaError_t launch_bwd(const void* q, const void* k, const void* v, const void* o,
                       const void* dout, const float* lse, float* delta, void* dq, void* dk,
                       void* dv, int B, int S, int H, int Hkv, int window, cudaStream_t stream) {
    using C = Cfg<D>;
    Params p;
    if (!encode_heads(&p.q, q, B, S, H, D) || !encode_heads(&p.dout, dout, B, S, H, D) ||
        !encode_heads(&p.k, k, B, S, Hkv, D) || !encode_heads(&p.v, v, B, S, Hkv, D))
        return cudaErrorNotSupported;
    p.o = static_cast<const __nv_bfloat16*>(o);
    p.dout_ptr = static_cast<const __nv_bfloat16*>(dout);
    p.lse = lse;
    p.delta = delta;
    p.dq = static_cast<__nv_bfloat16*>(dq);
    p.dk = static_cast<__nv_bfloat16*>(dk);
    p.dv = static_cast<__nv_bfloat16*>(dv);
    p.S = S;
    p.H = H;
    p.Hkv = Hkv;
    p.window = window;
    p.scale = (float)(1.0 / sqrt((double)D));
    p.scale_log2 = (float)(1.4426950408889634 / sqrt((double)D));
    cudaError_t e = cudaFuncSetAttribute(flash_bwd_dq_wgmma<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, C::q_smem());
    if (e != cudaSuccess) return e;
    e = cudaFuncSetAttribute(flash_bwd_dkdv_wgmma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             C::kv_smem());
    if (e != cudaSuccess) return e;
    flash_bwd_dq_wgmma<D><<<dim3(H, B, (S + C::kQRows - 1) / C::kQRows), 128 * (C::kDqWgs + 1),
                            C::q_smem(), stream>>>(p);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    flash_bwd_dkdv_wgmma<D><<<dim3(Hkv, B, (S + C::kKvRows - 1) / C::kKvRows), 384,
                              C::kv_smem(), stream>>>(p);
    return cudaGetLastError();
}

// 2 = the wgmma design (D 64, 128, 256), 1 = mma.sync (other multiples of 16)
inline bool takes(int D) { return D == 64 || D == 128 || D == 256; }

cudaError_t launch(const void* q, const void* k, const void* v, const void* o, const void* dout,
                   const float* lse, float* delta, void* dq, void* dk, void* dv, int B, int S,
                   int H, int Hkv, int D, int window, cudaStream_t stream) {
    switch (D) {
        case 64:
            return launch_bwd<64>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, S, H, Hkv, window,
                                  stream);
        case 128:
            return launch_bwd<128>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, S, H, Hkv,
                                   window, stream);
        case 256:
            return launch_bwd<256>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, S, H, Hkv,
                                   window, stream);
        default:
            return cudaErrorInvalidValue;
    }
}

}  // namespace wg

}  // namespace

extern "C" {

// route: 0 = CUDA cores (float32 or bfloat16, any D up to 256), 1 = tensor
// cores (bfloat16 only, D a multiple of 16, q, k and v 16-byte aligned).
// dtype: 0 = float32, 1 = bfloat16 (q, k, v and o share it).  causal: 0 or
// 1; window: 0 for none, else the number of positions a row looks back
// (itself included).  lse: null, or a float32 (B, H, S) buffer that
// receives each row's log-sum-exp of its scaled scores (m + log l; not
// defined for a row with no key); o is the same either way.  Returns a
// cudaError_t: 0 on success, cudaErrorInvalidValue for a route, dtype or
// shape the kernel does not take.
int flash_attention_launch(int route, int dtype, const void* q, const void* k, const void* v,
                           void* o, float* lse, int B, int S, int T, int H, int Hkv, int D,
                           int t_real, int causal, int window, void* stream) {
    if (B < 1 || S < 1 || T < 1 || Hkv < 1 || H < Hkv || H % Hkv != 0 || D < 1 ||
        D > kMaxD || t_real < 1 || t_real > T || window < 0 || B > 65535 || H > 65535)
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (route == 1) {
        const bool aligned = ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                               reinterpret_cast<uintptr_t>(v)) & 15) == 0 &&
                             (reinterpret_cast<uintptr_t>(o) & 3) == 0;
        if (dtype != 1 || D % 16 != 0 || !aligned) return (int)cudaErrorInvalidValue;
        return (int)tc::launch(q, k, v, o, lse, B, S, T, H, Hkv, D, t_real, causal, window, s);
    }
    if (route != 0) return (int)cudaErrorInvalidValue;
    if (dtype == 0)
        return (int)cc::launch<float>(q, k, v, o, lse, B, S, T, H, Hkv, D, t_real, causal,
                                      window, s);
    if (dtype == 1)
        return (int)cc::launch<__nv_bfloat16>(q, k, v, o, lse, B, S, T, H, Hkv, D, t_real,
                                              causal, window, s);
    return (int)cudaErrorInvalidValue;
}

// The backward of an aligned causal self-attention (S == T == t_real, key j
// attended by row i iff j <= i and, with window > 0, j > i - window): from
// q, k, v, the forward's o and lse and the output gradient dout (o's
// layout and dtype), writes dq (q's layout) and dk, dv (k's layout) in the
// inputs' dtype; delta is a float32 (B, H, S) work buffer.  route and dtype
// as above.  On the wgmma design (flash_attention_backward_kernel_of = 2)
// two launches on the stream: dQ (which writes delta), then dK/dV; on the
// others three: the delta pre-pass, dK/dV, dQ.
int flash_attention_backward_launch(int route, int dtype, const void* q, const void* k,
                                    const void* v, const void* o, const void* dout,
                                    const float* lse, float* delta, void* dq, void* dk,
                                    void* dv, int B, int S, int H, int Hkv, int D, int window,
                                    void* stream) {
    if (B < 1 || S < 1 || Hkv < 1 || H < Hkv || H % Hkv != 0 || D < 1 || D > kMaxD ||
        window < 0 || B > 65535 || H > 65535 || lse == nullptr || delta == nullptr)
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (route == 1) {
        const uintptr_t in = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                             reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(dout);
        const uintptr_t out = reinterpret_cast<uintptr_t>(dq) | reinterpret_cast<uintptr_t>(dk) |
                              reinterpret_cast<uintptr_t>(dv);
        if (dtype != 1 || D % 16 != 0 || (in & 15) != 0 ||
            ((out | reinterpret_cast<uintptr_t>(o)) & 3) != 0)
            return (int)cudaErrorInvalidValue;
        if (wg::takes(D))
            return (int)wg::launch(q, k, v, o, dout, lse, delta, dq, dk, dv, B, S, H, Hkv, D,
                                   window, s);
        cudaError_t e = cc::launch_delta<__nv_bfloat16>(o, dout, delta, B, S, H, D, s);
        if (e != cudaSuccess) return (int)e;
        return (int)tc::launch_bwd(q, k, v, dout, lse, delta, dq, dk, dv, B, S, H, Hkv, D,
                                   window, s);
    }
    if (route != 0) return (int)cudaErrorInvalidValue;
    if (dtype == 0) {
        cudaError_t e = cc::launch_delta<float>(o, dout, delta, B, S, H, D, s);
        if (e != cudaSuccess) return (int)e;
        return (int)cc::launch_bwd<float>(q, k, v, dout, lse, delta, dq, dk, dv, B, S, H, Hkv,
                                          D, window, s);
    }
    if (dtype == 1) {
        cudaError_t e = cc::launch_delta<__nv_bfloat16>(o, dout, delta, B, S, H, D, s);
        if (e != cudaSuccess) return (int)e;
        return (int)cc::launch_bwd<__nv_bfloat16>(q, k, v, dout, lse, delta, dq, dk, dv, B, S,
                                                  H, Hkv, D, window, s);
    }
    return (int)cudaErrorInvalidValue;
}

// The backward design flash_attention_backward_launch runs for a dtype and
// head dim on the route the wrapper picks for them (bf16 at a multiple of
// 16 on the tensor cores): 2 = wgmma (D 64, 128, 256), 1 = mma.sync
// (other multiples of 16), 0 = CUDA cores, -1 for a dtype it does not take.
// The wrapper counts launches by it, so the rule lives here only.
int flash_attention_backward_kernel_of(int dtype, int D) {
    if (dtype != 0 && dtype != 1) return -1;
    if (dtype != 1 || D % 16 != 0) return 0;
    return wg::takes(D) ? 2 : 1;
}

// The wgmma backward's tiles at head dim D, for the CPU model of its walks
// (kernels/flash_attention/plan.py): out = {kv rows of a dK/dV block, q
// rows of its items, its consumer warpgroups split the columns (0 or 1),
// q rows of a dQ block, kv rows of its steps, the dK/dV ring's stages, the
// dQ ring's stages}.  Returns 0, or -1 where D does not take that design.
int flash_attention_backward_plan(int D, int* out) {
    if (!wg::takes(D)) return -1;
#define FA_PLAN(DD)                                                                            \
    {                                                                                          \
        using C = wg::Cfg<DD>;                                                                 \
        const int v[7] = {C::kKvRows, wg::kTile, C::kSplit ? 1 : 0, C::kQRows, wg::kTile,      \
                          C::kKvStages, C::kQStages};                                          \
        for (int i = 0; i < 7; ++i) out[i] = v[i];                                             \
    }
    if (D == 64) FA_PLAN(64) else if (D == 128) FA_PLAN(128) else FA_PLAN(256)
#undef FA_PLAN
    return 0;
}

const char* flash_attention_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
