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
// inputs' dtype; delta is a float32 (B, H, S) work buffer.  Three launches
// on the stream: the delta pre-pass, dK/dV, dQ.  route and dtype as above.
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
        if (dtype != 1 || D % 16 != 0 || (in & 15) != 0 || (out & 3) != 0)
            return (int)cudaErrorInvalidValue;
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

const char* flash_attention_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
