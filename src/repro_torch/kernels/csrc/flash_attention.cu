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
// j <= i when causal, and j > i - window when window > 0.  Arithmetic as in
// the TPU kernel: q is scaled by 1/sqrt(D) in fp32 before Q.K^T, masked
// scores are the finite -1e30, and the running max, normaliser and the
// accumulator are fp32.  A row with no key to attend (only when S > T
// under a window) comes out as the mean of v over the t_real rows: the
// value a plain softmax over equally masked scores gives.
//
// Design: one block of 256 threads per (q tile of 64 rows, head, batch
// row); the kv loop runs inside the block (the TPU kernel's sequential
// grid axis).  The block stages its q tile (pre-scaled) and one kv tile of
// 64 rows at a time in shared memory as fp32, K first and then V in the
// same buffer.  Each thread of the 16 x 16 grid computes a 4 x 4 tile of
// the 64 x 64 scores (rows ty + 16 i, columns tx + 16 j), so the 16 lanes
// of a half warp read 16 rows of K with an odd stride (no bank conflict)
// and the two half warps broadcast q.  The online-softmax statistics of a
// row are reduced across its 16 lanes with shuffles and kept, replicated,
// in those lanes' registers.  The probabilities go through shared memory to
// the P.V product, in which each thread accumulates 4 rows x ceil(D/16)
// columns of the output in registers.  Key tiles wholly above the diagonal
// (causal) or below the window are skipped; q tiles run last-first so the
// longest causal blocks start first.
//
// Bound on the H100 (3.35 TB/s HBM; 67 TFLOP/s fp32 outside the tensor
// cores, 989 TFLOP/s dense bf16 on them): at qwen3-14b's 4096-token prefill
// (B=1, H=40, Hkv=8, D=128) the causal work is 2 S^2 D H = 171.8 GFLOP
// against about 101 MB of q, k, v and o, so the kernel is bound by
// operations.  This kernel runs them on the fp32 pipes, and shared-memory
// loads (8 per 16 FMAs in Q.K^T) stand between it and even that peak;
// wgmma on bf16 tiles staged by TMA is the way to the tensor cores' bound,
// left for later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kGrid = 16;       // 16 x 16 thread grid
constexpr int kRows = 4;        // q rows per thread (strided by kGrid)
constexpr int kBQ = kGrid * kRows;   // 64 q rows per block
constexpr int kBK = 64;              // kv rows per tile
constexpr int kCols = kBK / kGrid;   // score columns per thread
constexpr float kNegInf = -1e30f;
constexpr int kMaxD = 256;

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
                  T* __restrict__ o, int S, int T_, int H, int Hkv, int D, int t_real,
                  int causal, int window, float scale) {
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
        T* orow = o + (((int64_t)b * S + r) * H + h) * D;
#pragma unroll
        for (int c = 0; c < DPT; ++c) {
            const int col = tx + kGrid * c;
            if (col < D) store(orow + col, acc[i][c] * inv);
        }
    }
}

template <typename T, int DPT>
cudaError_t launch_dpt(const void* q, const void* k, const void* v, void* o, int B, int S,
                       int T_, int H, int Hkv, int D, int t_real, int causal, int window,
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
        static_cast<T*>(o), S, T_, H, Hkv, D, t_real, causal, window,
        (float)(1.0 / sqrt((double)D)));
    return cudaGetLastError();
}

template <typename T>
cudaError_t launch_typed(const void* q, const void* k, const void* v, void* o, int B, int S,
                         int T_, int H, int Hkv, int D, int t_real, int causal, int window,
                         cudaStream_t stream) {
    if (D <= 16)
        return launch_dpt<T, 1>(q, k, v, o, B, S, T_, H, Hkv, D, t_real, causal, window, stream);
    if (D <= 32)
        return launch_dpt<T, 2>(q, k, v, o, B, S, T_, H, Hkv, D, t_real, causal, window, stream);
    if (D <= 64)
        return launch_dpt<T, 4>(q, k, v, o, B, S, T_, H, Hkv, D, t_real, causal, window, stream);
    if (D <= 128)
        return launch_dpt<T, 8>(q, k, v, o, B, S, T_, H, Hkv, D, t_real, causal, window, stream);
    return launch_dpt<T, 16>(q, k, v, o, B, S, T_, H, Hkv, D, t_real, causal, window, stream);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and o share it).  causal: 0 or
// 1; window: 0 for none, else the number of positions a row looks back
// (itself included).  Returns a cudaError_t: 0 on success,
// cudaErrorInvalidValue for a dtype or shape the kernel does not take.
int flash_attention_launch(int dtype, const void* q, const void* k, const void* v, void* o,
                           int B, int S, int T, int H, int Hkv, int D, int t_real, int causal,
                           int window, void* stream) {
    if (B < 1 || S < 1 || T < 1 || Hkv < 1 || H < Hkv || H % Hkv != 0 || D < 1 ||
        D > kMaxD || t_real < 1 || t_real > T || window < 0 || B > 65535 || H > 65535)
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype == 0)
        return (int)launch_typed<float>(q, k, v, o, B, S, T, H, Hkv, D, t_real, causal, window, s);
    if (dtype == 1)
        return (int)launch_typed<__nv_bfloat16>(q, k, v, o, B, S, T, H, Hkv, D, t_real, causal,
                                                window, s);
    return (int)cudaErrorInvalidValue;
}

const char* flash_attention_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
