// Mamba-2 SSD chunked scan for Hopper (sm_90a), bound through a plain C
// interface and loaded with ctypes (repro_torch/kernels/ssd_scan/kernel.py).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/ssd_scan/kernel.py::ssd_scan_kernel (body _ssd_kernel)
// and goes one step beyond its contract, to the one of the JAX package's
// models/mamba2.py::ssd_chunked: it enters from an initial state h0 and
// returns the final state, so chunked prefill and decode carry the state
// across calls.
//
//   x (B, L, H, P), Bm and Cm (B, L, N) (one group shared by every head), in
//   float32 or bfloat16 (one dtype for the three); dt (B, L, H), A (H,) and
//   h0 (B, H, P, N) float32 (h0 may be null: a zero state).
//   -> y (B, L, H, P) in x's dtype, h_final (B, H, P, N) float32.
//
// Per chunk of q <= Q tokens, with cums the inclusive cumsum of dt * A:
//   W[i][j]   = (C_i . B_j) * exp(cums_i - cums_j) * dt_j   for j <= i, else 0
//   y_i       = sum_j W[i][j] x_j + exp(cums_i) * (C_i . h_prev)
//   h_new     = exp(cums_{q-1}) h_prev + sum_j exp(cums_{q-1} - cums_j) dt_j x_j B_j^T
// Only j <= i ever reaches the exponential's result, so a positive
// difference is never used (cums falls to -thousands over a chunk, and exp
// of it underflows to 0, which is right).  Row p of the state and column p
// of y depend on x[:, :, p] alone, so the work splits over P with no
// exchange between blocks.
//
// Two routes, chosen from the dtype and the dims alone (ssd_scan_route):
//
// * Tensor cores (bfloat16, P a multiple of 16, N = 64, 128 or 256; the
//   route mamba2-1.3b serves on: H = 64, P = 64, N = 128).
//   - L >= 2: one block of 4 warps per (head, slab of PT = 32 state rows
//     (16 where P is not a multiple of 32), batch row): 128 blocks at B = 1.
//     The block walks the chunks (Q = 128 tokens, 64 at N = 256) with its
//     PT x N slab of the fp32 state in registers (a warp owns N / 4
//     columns).  A chunk's C, B (Q x N), x (Q x PT) bf16 and dt land in
//     shared memory by cp.async in two stages: warps 1-3 issue the copy of
//     chunk c + 1 while warp 0 scans chunk c's dt * A, and it runs while
//     chunk c computes.  The products run on mma.sync.m16n8k16 (bf16
//     operands, fp32 sums) fed by ldmatrix, as in flash_attention.cu.  A
//     warp owns two 16-row m-tiles of the chunk (rows 16k and Q - 16 - 16k,
//     so causal work is even across warps) and, per m-tile, computes
//       C . h_prev^T (then scaled by exp(cums_i)),
//       G = C . B^T one 16 x 16 tile at a time for j <= i, turned in
//       registers into W (decay, dt, and on the diagonal tile the mask,
//       as an exponent of -inf: no branch) and re-packed as the A operand
//       of W . x, as flash re-packs its probabilities.
//     Then the state: h = exp(cums_last) h + (x * wend)^T . B, each warp on
//     its own columns.  C . B^T is computed once per chunk in each block
//     and not shared: one group serves every head, but sharing it would
//     take a second launch and a Q x Q fp32 scratch per chunk read back by
//     all 128 blocks, while recomputing its causal half costs each block
//     about a third of its MMAs, on operands already staged.  Independent
//     accumulators (even and odd k steps of C . B^T, the hi and the lo
//     halves of each split product) keep several MMA chains in flight.
//     Numerics: x, B and C are bf16 values, so C . B^T and every product
//     that takes them directly is exact products summed in fp32.  The three
//     fp32 operands (W, h_prev and x * wend) enter as a bf16 hi + lo pair,
//     two MMAs per product: each is then off by at most u^2 = 2^-16 of its
//     size.  The state stays fp32 in registers and memory; only its bf16
//     hi + lo copy for C . h_prev lives in shared memory.  y is rounded to
//     bf16 once, at the store.  kernels/ssd_scan/ref.py::bf16_rounding_bound
//     is the per-element limit these roundings give.
//   - L = 1 (decode): no product there is worth a tensor core: the step is a
//     rank-one update of each state row and its dot product with C.  One
//     warp streams 4 state rows of N floats (16-byte loads, every lane), in
//     fp32, and reduces C . h_new across the warp.  Bound by the state's
//     bytes.
//
// * CUDA cores (float32, which phase 10's fp32 cases hold to 1e-4, and
//   bfloat16 at any other P or N, such as the sweeps' P = 4, N = 8).  One
//   block of 256 threads per (head, batch row)
//   walks the sequence in chunks of up to 64 tokens with the (P, N) fp32
//   state in shared memory, the four contractions one after another
//   through a 16 x 16 thread grid of 4 x 4 register tiles, all fp32.
//
// Backward (ssd_scan_backward_launch): the adjoint of the above given dy and
// the final state's gradient (or none) -> dx, ddt, dA, dBm, dCm and dh0, on
// the forward's two routes by the forward's rule (route_of; the note at the
// head of namespace bwd gives the tensor-core route's design).  Three
// launches on each: the state passes (the state entering each chunk,
// walked forwards from h0, and the adjoint dh of the state leaving each
// chunk, walked backwards from dh_final: dh_prev = exp(cums_last) dh +
// sum_i exp(cums_i) dy_i C_i^T; what is left after the first chunk is
// dh0), a chunk kernel for every gradient term, and a fixed-order
// reduction.  The backward runs the forward's recurrence again rather than
// have the forward write its chunk-entry states: the serving forward stays
// as it is, its chunks need not be the backward's, and under remat the
// recompute would write them a second time anyway.
//   * CUDA cores (float32, and bfloat16 at other P or N): fp32 arithmetic
//     on chunks of up to 64 tokens (the most shared memory holds): fp32
//     states (B, nc, H, P, N); one block per (head, chunk, batch row)
//     through seven tile products (C B^T, dy x^T, dx, and two each for dC
//     and dB) and a serial pass over the chunk's d(cums) and its reversed
//     cumsum; the head's share of dB and dC to (B, L, H, N) fp32 partials,
//     of dA to (B, nc, H), summed over heads (and chunks) by the third
//     launch.
//   * Tensor cores: mma.sync, 64-token chunks (32 at N = 256), one chunk
//     block per (chunk, batch row) walking the heads, no per-head
//     partials; only dA's (B, nc, H) shares are summed by the third launch.
// The mask is a select (a pair j > i never uses an exponential).  Every sum
// over blocks is a second pass in a fixed order, so two launches on the
// same inputs are bitwise equal: no floating-point atomics.  The chunk's
// cumsum of dt A is one function with rounded operations only (no fma
// contraction), so the passes and the chunk kernel see the same bits.
// kernels/ssd_scan/ref.py::bf16_backward_rounding_bound is the per-element
// limit against the plain backward, on each route.
//
// Bound on the H100 (3.35 TB/s HBM; 989 TFLOP/s dense bf16 on the tensor
// cores): a 256-token prefill chunk of mamba2-1.3b (B=1, H=64, P=64, N=128)
// must move about 8.5 MB (x and y bf16, B, C, dt, h0 and h_final fp32), 2.5
// us, against about 1 GFLOP of the chunked form, 1 us at the bf16 rate: it
// is bound by bytes.  A decode step (B=8, L=1) moves 33.6 MB of state, 10
// us.  What keeps the chunk kernel from its bound: mma.sync's issue rate
// (the hi + lo splits double three of the four products; wgmma would
// raise the rate), 128 blocks (one an SM, for their 192 KB of shared
// memory) of 4 warps, one warp a scheduler, so ldmatrix -> mma chains and
// the three barriers of a chunk are exposed, the per-thread 16-byte
// cp.async staging of the next chunk, and the first chunk's copy, which
// nothing overlaps.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxSmem = 232448;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
    return __float2bfloat16_rn(x);
}

// ---------------------------------------------------------------------------
// CUDA-core route (float32; bfloat16 at other P or N)

namespace cc {

constexpr int kThreads = 256;
constexpr int kGrid = 16;       // 16 x 16 thread grid over an output tile
constexpr int kReg = 4;         // 4 x 4 outputs per thread, strided by kGrid
constexpr int kMaxQ = 64;       // chunk length cap (the scan is one warp, 2 per lane)

__host__ __device__ __forceinline__ int odd(int v) { return v | 1; }

// Shared-memory layout, in floats; the host sizes the launch with the same
// arithmetic.
struct Layout {
    int ldS, ldB, ldC;          // leading dims of St, Bs, Ct
    int St, Bs, Ct, Xs, Wt, cums, dtv, wend, ecum, total;

    __host__ __device__ Layout(int P, int N, int Q) {
        ldS = odd(P);           // St[n][p]: the state, transposed
        ldB = odd(N);           // Bs[j][n]
        ldC = odd(Q);           // Ct[n][i]
        St = 0;
        Bs = St + N * ldS;
        Ct = Bs + Q * ldB;
        Xs = Ct + N * ldC;      // Xs[j][p]
        Wt = Xs + Q * P;        // Wt[j][i]
        cums = Wt + Q * Q;
        dtv = cums + Q;
        wend = dtv + Q;         // exp(cums_last - cums_j) * dt_j
        ecum = wend + Q;        // exp(cums_i)
        total = ecum + Q;
    }
};

// out(m, n) = sum_k la(m, k) * lb(k, n) over an M x NN output, handed to
// epi(m, n, value).  Thread (tm, tn) of the 16 x 16 grid owns rows
// m0 + tm + 16 r and columns n0 + tn + 16 c, r, c < 4.
template <class LA, class LB, class Epi>
__device__ __forceinline__ void tile_product(int M, int NN, int K, LA la, LB lb, Epi epi) {
    const int tm = threadIdx.x / kGrid, tn = threadIdx.x % kGrid;
    for (int m0 = 0; m0 < M; m0 += kGrid * kReg) {
        if (m0 + tm >= M) continue;
        for (int n0 = 0; n0 < NN; n0 += kGrid * kReg) {
            if (n0 + tn >= NN) continue;
            float acc[kReg][kReg];
#pragma unroll
            for (int r = 0; r < kReg; ++r)
#pragma unroll
                for (int c = 0; c < kReg; ++c) acc[r][c] = 0.f;
            for (int k = 0; k < K; ++k) {
                float a[kReg], b[kReg];
#pragma unroll
                for (int r = 0; r < kReg; ++r) {
                    const int m = m0 + tm + kGrid * r;
                    a[r] = m < M ? la(m, k) : 0.f;
                }
#pragma unroll
                for (int c = 0; c < kReg; ++c) {
                    const int n = n0 + tn + kGrid * c;
                    b[c] = n < NN ? lb(k, n) : 0.f;
                }
#pragma unroll
                for (int r = 0; r < kReg; ++r)
#pragma unroll
                    for (int c = 0; c < kReg; ++c) acc[r][c] = fmaf(a[r], b[c], acc[r][c]);
            }
#pragma unroll
            for (int r = 0; r < kReg; ++r) {
                const int m = m0 + tm + kGrid * r;
#pragma unroll
                for (int c = 0; c < kReg; ++c) {
                    const int n = n0 + tn + kGrid * c;
                    if (m < M && n < NN) epi(m, n, acc[r][c]);
                }
            }
        }
    }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) ssd_scan_kernel(
    const T* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ A,
    const T* __restrict__ Bm, const T* __restrict__ Cm, const float* __restrict__ h0,
    T* __restrict__ y, float* __restrict__ hout, int L, int H, int P, int N, int Q) {
    extern __shared__ float smem[];
    const Layout lay(P, N, Q);
    float* St = smem + lay.St;
    float* Bs = smem + lay.Bs;
    float* Ct = smem + lay.Ct;
    float* Xs = smem + lay.Xs;
    float* Wt = smem + lay.Wt;
    float* cums = smem + lay.cums;
    float* dtv = smem + lay.dtv;
    float* wend = smem + lay.wend;
    float* ecum = smem + lay.ecum;
    const int ldS = lay.ldS, ldB = lay.ldB, ldC = lay.ldC;

    const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
    const int PN = P * N;
    const int64_t state_off = ((int64_t)b * H + h) * PN;
    const float a_h = A[h];

    // the state enters transposed, St[n][p], read along n (coalesced)
    for (int idx = tid; idx < PN; idx += kThreads) {
        const int p = idx / N, n = idx - p * N;
        St[n * ldS + p] = h0 ? h0[state_off + idx] : 0.f;
    }

    for (int t0 = 0; t0 < L; t0 += Q) {
        const int q = min(Q, L - t0);
        const int64_t tok0 = (int64_t)b * L + t0;      // first token's row
        __syncthreads();    // the previous chunk's readers are done
        for (int idx = tid; idx < q; idx += kThreads) dtv[idx] = dt[(tok0 + idx) * H + h];
        for (int idx = tid; idx < q * P; idx += kThreads) {
            const int j = idx / P, p = idx - j * P;
            Xs[idx] = to_float(x[((tok0 + j) * H + h) * P + p]);
        }
        for (int idx = tid; idx < q * N; idx += kThreads) {
            const int j = idx / N, n = idx - j * N;
            const int64_t g = (tok0 + j) * N + n;
            Bs[j * ldB + n] = to_float(Bm[g]);
            Ct[n * ldC + j] = to_float(Cm[g]);
        }
        __syncthreads();

        // inclusive cumsum of dt * A over the chunk: one warp, 2 tokens a lane
        if (tid < 32) {
            const int t = 2 * tid;
            const float d0 = t < q ? dtv[t] * a_h : 0.f;
            const float d1 = t + 1 < q ? dtv[t + 1] * a_h : 0.f;
            float s = d0 + d1;
#pragma unroll
            for (int off = 1; off < 32; off <<= 1) {
                const float v = __shfl_up_sync(0xffffffffu, s, off);
                if (tid >= off) s += v;
            }
            const float before = s - (d0 + d1);
            if (t < q) cums[t] = before + d0;
            if (t + 1 < q) cums[t + 1] = s;
        }
        __syncthreads();
        const float last = cums[q - 1];
        for (int idx = tid; idx < q; idx += kThreads) {
            ecum[idx] = expf(cums[idx]);
            wend[idx] = expf(last - cums[idx]) * dtv[idx];
        }

        // 1. C . B^T -> Wt[j][i], masked inside the exponential
        tile_product(
            q, q, N,
            [=](int j, int n) { return Bs[j * ldB + n]; },
            [=](int n, int i) { return Ct[n * ldC + i]; },
            [=](int j, int i, float g) {
                Wt[j * Q + i] = j <= i ? g * expf(cums[i] - cums[j]) * dtv[j] : 0.f;
            });
        __syncthreads();

        // 2. y_i = sum_j W[i][j] x_j + exp(cums_i) C_i . h_prev, depth q + N
        tile_product(
            q, P, q + N,
            [=](int i, int k) {
                return k < q ? Wt[k * Q + i] : Ct[(k - q) * ldC + i] * ecum[i];
            },
            [=](int k, int p) { return k < q ? Xs[k * P + p] : St[(k - q) * ldS + p]; },
            [=](int i, int p, float v) {
                y[((tok0 + i) * H + h) * P + p] = from_float<T>(v);
            });
        __syncthreads();

        // 3. h = exp(cums_last) h_prev + sum_j wend_j x_j B_j^T, in place
        const float chunk_decay = ecum[q - 1];
        tile_product(
            P, N, q,
            [=](int p, int j) { return Xs[j * P + p] * wend[j]; },
            [=](int j, int n) { return Bs[j * ldB + n]; },
            [=](int p, int n, float v) {
                float& s = St[n * ldS + p];
                s = fmaf(s, chunk_decay, v);
            });
    }
    __syncthreads();
    for (int idx = tid; idx < PN; idx += kThreads) {
        const int p = idx / N, n = idx - p * N;
        hout[state_off + idx] = St[n * ldS + p];
    }
}

int chunk_for(int L, int P, int N) {
    for (int Q = kMaxQ; Q >= 1; Q /= 2) {
        const int q = Q < L ? Q : L;
        if ((int64_t)Layout(P, N, q).total * 4 <= kMaxSmem) return q;
    }
    return 0;
}

template <typename T>
cudaError_t launch_typed(const void* x, const float* dt, const float* A, const void* Bm,
                         const void* Cm, const float* h0, void* y, float* hout, int B, int L,
                         int H, int P, int N, cudaStream_t stream) {
    const int Q = chunk_for(L, P, N);
    if (Q == 0) return cudaErrorInvalidValue;
    const int smem = Layout(P, N, Q).total * (int)sizeof(float);
    if (smem > 48 * 1024) {     // above 48 KB only after opting in
        cudaError_t e = cudaFuncSetAttribute(
            ssd_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (e != cudaSuccess) return e;
    }
    const dim3 grid(H, B);
    ssd_scan_kernel<T><<<grid, kThreads, smem, stream>>>(
        static_cast<const T*>(x), dt, A, static_cast<const T*>(Bm), static_cast<const T*>(Cm),
        h0, static_cast<T*>(y), hout, L, H, P, N, Q);
    return cudaGetLastError();
}

}  // namespace cc

// ---------------------------------------------------------------------------
// Tensor-core route (bfloat16, P a multiple of 16, N = 64, 128 or 256)

namespace tc {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kDecodeWarps = 8;
constexpr int kDecodeRows = 4;          // state rows a decode warp streams

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 (or 4) bytes global -> shared; with valid false the bytes are zero-filled
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
                 "r"(valid ? 16 : 0)
                 : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool valid) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
                 "r"(valid ? 4 : 0)
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

// (a, b) as bf16 pairs hi = rn(v), lo = rn(v - hi): hi + lo is v within
// 2^-16 |v| (v - hi is exact in fp32)
__device__ __forceinline__ void split2(float a, float b, uint32_t& hi, uint32_t& lo) {
    __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
    const float2 hf = __bfloat1622float2(h);
    __nv_bfloat162 l = __floats2bfloat162_rn(a - hf.x, b - hf.y);
    hi = *reinterpret_cast<uint32_t*>(&h);
    lo = *reinterpret_cast<uint32_t*>(&l);
}

// Shared memory of the chunk kernel, in bytes: two stages of (C, B, x, dt),
// then the state's hi and lo copies, (x * wend)^T hi and lo, cums, ecum,
// wend.  bf16 rows are padded by 8 elements (16 bytes) so that ldmatrix
// meets no bank conflict.
template <int N, int PT>
struct Tile {
    static constexpr int Q = N > 128 ? 64 : 128;      // chunk length
    static constexpr int MT = Q / 16;                 // 16-row m-tiles of a chunk
    static constexpr int LDN = N + 8, LDP = PT + 8, LDQ = Q + 8;
    static constexpr int NW = N / kWarps;             // state columns a warp owns
    static constexpr int NBW = NW / 8;                // its 8-column blocks
    static constexpr int C_ = 0;
    static constexpr int B_ = C_ + Q * LDN * 2;
    static constexpr int X_ = B_ + Q * LDN * 2;
    static constexpr int DT_ = X_ + Q * LDP * 2;
    static constexpr int STAGE = DT_ + Q * 4;
    static constexpr int HHI = 2 * STAGE;
    static constexpr int HLO = HHI + PT * LDN * 2;
    static constexpr int UHI = HLO + PT * LDN * 2;
    static constexpr int ULO = UHI + PT * LDQ * 2;
    static constexpr int CUMS = ULO + PT * LDQ * 2;
    static constexpr int ECUM = CUMS + Q * 4;
    static constexpr int WEND = ECUM + Q * 4;
    static constexpr int BYTES = WEND + Q * 4;
    static_assert(NBW % 2 == 0, "a warp's state columns come in 16-column ldmatrix pairs");
    static_assert(BYTES <= kMaxSmem, "chunk tiles exceed shared memory");
};

// Fragment layout of m16n8k16 (lane = 4 gr + tq): an output block c[0..1]
// holds row gr, columns 2 tq and 2 tq + 1; c[2..3] the same columns of row
// gr + 8.
template <int N, int PT>
__global__ void __launch_bounds__(kThreads, 1)
ssd_chunk_kernel(const bf16* __restrict__ x, const float* __restrict__ dt,
                 const float* __restrict__ A, const bf16* __restrict__ Bm,
                 const bf16* __restrict__ Cm, const float* __restrict__ h0,
                 bf16* __restrict__ y, float* __restrict__ hout, int L, int H, int P) {
    using T = Tile<N, PT>;
    constexpr int Q = T::Q, MT = T::MT, LDN = T::LDN, LDP = T::LDP, LDQ = T::LDQ;
    constexpr int NBW = T::NBW, MS = PT / 16, PB = PT / 16;
    extern __shared__ __align__(16) unsigned char smem[];
    bf16* Hhi = reinterpret_cast<bf16*>(smem + T::HHI);
    bf16* Hlo = reinterpret_cast<bf16*>(smem + T::HLO);
    bf16* Uhi = reinterpret_cast<bf16*>(smem + T::UHI);
    bf16* Ulo = reinterpret_cast<bf16*>(smem + T::ULO);
    float* cums = reinterpret_cast<float*>(smem + T::CUMS);
    float* ecum = reinterpret_cast<float*>(smem + T::ECUM);
    float* wend = reinterpret_cast<float*>(smem + T::WEND);

    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int gr = lane >> 2, tq = lane & 3;
    const int h = blockIdx.x, p0 = blockIdx.y * PT, b = blockIdx.z;
    const float a_h = A[h];
    const int n_chunks = (L + Q - 1) / Q;
    const int nw0 = warp * T::NW;

    // copy chunk c's C, B, x and dt into stage c & 1 (rows past L zero),
    // spread over threads t0, t0 + nt, ...
    auto issue = [&](int c, int t0, int nt) {
        unsigned char* st = smem + (c & 1) * T::STAGE;
        bf16* Cs = reinterpret_cast<bf16*>(st + T::C_);
        bf16* Bs = reinterpret_cast<bf16*>(st + T::B_);
        bf16* Xs = reinterpret_cast<bf16*>(st + T::X_);
        float* dts = reinterpret_cast<float*>(st + T::DT_);
        const int q = min(Q, L - c * Q);
        const int64_t tok0 = (int64_t)b * L + c * Q;
        constexpr int NCH = N / 8, PCH = PT / 8;        // 16-byte chunks a row
        for (int i = t0; i < Q * NCH; i += nt) {
            const int r = i / NCH, c8 = (i - r * NCH) * 8;
            const bool ok = r < q;
            const int64_t g = (tok0 + (ok ? r : 0)) * N + c8;
            cp_async16(smem_addr(Cs + r * LDN + c8), Cm + g, ok);
            cp_async16(smem_addr(Bs + r * LDN + c8), Bm + g, ok);
        }
        for (int i = t0; i < Q * PCH; i += nt) {
            const int r = i / PCH, c8 = (i - r * PCH) * 8;
            const bool ok = r < q;
            cp_async16(smem_addr(Xs + r * LDP + c8),
                       x + ((tok0 + (ok ? r : 0)) * H + h) * P + p0 + c8, ok);
        }
        for (int r = t0; r < Q; r += nt) {
            const bool ok = r < q;
            cp_async4(smem_addr(dts + r), dt + (tok0 + (ok ? r : 0)) * H + h, ok);
        }
    };
    issue(0, tid, kThreads);
    cp_async_commit();

    // the warp's columns of the state slab, fp32, in registers for the
    // whole sequence
    const int64_t soff = ((int64_t)b * H + h) * P * N;
    float st[MS][NBW][4];
#pragma unroll
    for (int mt = 0; mt < MS; ++mt)
#pragma unroll
        for (int nb = 0; nb < NBW; ++nb) {
            const int64_t o = soff + (int64_t)(p0 + 16 * mt + gr) * N + nw0 + 8 * nb + 2 * tq;
            float2 v0 = make_float2(0.f, 0.f), v1 = v0;
            if (h0) {
                v0 = *reinterpret_cast<const float2*>(h0 + o);
                v1 = *reinterpret_cast<const float2*>(h0 + o + 8 * N);
            }
            st[mt][nb][0] = v0.x;
            st[mt][nb][1] = v0.y;
            st[mt][nb][2] = v1.x;
            st[mt][nb][3] = v1.y;
        }
    // the state's bf16 hi + lo copy, rows p, for C . h_prev
    auto split_state = [&]() {
#pragma unroll
        for (int mt = 0; mt < MS; ++mt)
#pragma unroll
            for (int nb = 0; nb < NBW; ++nb) {
                const int o = (16 * mt + gr) * LDN + nw0 + 8 * nb + 2 * tq;
                uint32_t hi, lo;
                split2(st[mt][nb][0], st[mt][nb][1], hi, lo);
                *reinterpret_cast<uint32_t*>(Hhi + o) = hi;
                *reinterpret_cast<uint32_t*>(Hlo + o) = lo;
                split2(st[mt][nb][2], st[mt][nb][3], hi, lo);
                *reinterpret_cast<uint32_t*>(Hhi + o + 8 * LDN) = hi;
                *reinterpret_cast<uint32_t*>(Hlo + o + 8 * LDN) = lo;
            }
    };
    split_state();

    // ldmatrix row addresses: A operands (row-major m x k) rows lane & 15,
    // column half lane >> 4; B from an n x k array (as flash's K) rows
    // (lane & 7) + 8 (lane >> 4), column half (lane >> 3) & 1; B from a
    // k x n array by .trans (as flash's V) rows (lane & 7) + 8 ((lane >> 3)
    // & 1), column half lane >> 4
    const int a_off_r = lane & 15, a_off_c = (lane >> 4) << 3;
    const int k_off_r = (lane & 7) + ((lane >> 4) << 3), k_off_c = ((lane >> 3) & 1) << 3;
    const int v_off_r = (lane & 7) + (((lane >> 3) & 1) << 3), v_off_c = (lane >> 4) << 3;

    for (int c = 0; c < n_chunks; ++c) {
        const int q = min(Q, L - c * Q);
        const int64_t tok0 = (int64_t)b * L + c * Q;
        cp_async_wait<0>();     // chunk c has landed (this thread's copies)
        // past this barrier: every copy of chunk c is visible, every warp is
        // done with chunk c - 1 (its stage is free) and the state's new
        // hi + lo copy is written
        __syncthreads();
        const unsigned char* stg = smem + (c & 1) * T::STAGE;
        const bf16* Cs = reinterpret_cast<const bf16*>(stg + T::C_);
        const bf16* Bs = reinterpret_cast<const bf16*>(stg + T::B_);
        const bf16* Xs = reinterpret_cast<const bf16*>(stg + T::X_);
        const float* dts = reinterpret_cast<const float*>(stg + T::DT_);

        // inclusive cumsum of dt * A over the chunk (padding has dt = 0):
        // warp 0, Q / 32 consecutive tokens a lane, while the other warps
        // issue the copy of chunk c + 1 (in flight while chunk c computes)
        if (warp != 0 && c + 1 < n_chunks) issue(c + 1, tid - 32, kThreads - 32);
        cp_async_commit();
        if (warp == 0) {
            constexpr int R = Q / 32;
            float v[R];
            float s = 0.f;
#pragma unroll
            for (int k = 0; k < R; ++k) {
                s += dts[lane * R + k] * a_h;
                v[k] = s;
            }
            float incl = s;
#pragma unroll
            for (int off = 1; off < 32; off <<= 1) {
                const float u = __shfl_up_sync(0xffffffffu, incl, off);
                if (lane >= off) incl += u;
            }
            float before = __shfl_up_sync(0xffffffffu, incl, 1);
            if (lane == 0) before = 0.f;
            const float last = __shfl_sync(0xffffffffu, incl, 31);
#pragma unroll
            for (int k = 0; k < R; ++k) {
                const int t = lane * R + k;
                const float cv = before + v[k];
                cums[t] = cv;
                ecum[t] = expf(cv);
                wend[t] = expf(last - cv) * dts[t];
            }
        }
        __syncthreads();

        // y for the warp's two m-tiles (rows 16 k and Q - 16 - 16 k)
        for (int k2 = warp; k2 < MT / 2; k2 += kWarps) {
#pragma unroll 1
            for (int side = 0; side < 2; ++side) {
                const int it = side ? MT - 1 - k2 : k2;
                const int i0 = 16 * it;
                if (i0 >= q) continue;
                uint32_t cf[N / 16][4];                 // C rows i0.., k = n
#pragma unroll
                for (int kk = 0; kk < N / 16; ++kk)
                    ldsm_x4(cf[kk], smem_addr(Cs + (i0 + a_off_r) * LDN + kk * 16 + a_off_c));
                // two accumulators, for the hi and the lo halves of the
                // split operand: independent MMA chains, summed at the end
                float acc[PT / 8][4], acl[PT / 8][4];
#pragma unroll
                for (int j = 0; j < PT / 8; ++j)
#pragma unroll
                    for (int e = 0; e < 4; ++e) acc[j][e] = acl[j][e] = 0.f;
                // C_i . h_prev, h_prev as hi + lo (rows p as n, k = n)
#pragma unroll
                for (int kk = 0; kk < N / 16; ++kk) {
#pragma unroll
                    for (int pb = 0; pb < PB; ++pb) {
                        uint32_t bh[4], bl[4];
                        const int o = (pb * 16 + k_off_r) * LDN + kk * 16 + k_off_c;
                        ldsm_x4(bh, smem_addr(Hhi + o));
                        ldsm_x4(bl, smem_addr(Hlo + o));
                        mma_bf16(acc[2 * pb], cf[kk], bh[0], bh[1]);
                        mma_bf16(acl[2 * pb], cf[kk], bl[0], bl[1]);
                        mma_bf16(acc[2 * pb + 1], cf[kk], bh[2], bh[3]);
                        mma_bf16(acl[2 * pb + 1], cf[kk], bl[2], bl[3]);
                    }
                }
                const int r0 = i0 + gr, r1 = r0 + 8;
                const float e0 = ecum[r0], e1 = ecum[r1];
                const float c0 = cums[r0], c1 = cums[r1];
#pragma unroll
                for (int j = 0; j < PT / 8; ++j) {
#pragma unroll
                    for (int e = 0; e < 4; ++e) {
                        acc[j][e] = (acc[j][e] + acl[j][e]) * (e < 2 ? e0 : e1);
                        acl[j][e] = 0.f;
                    }
                }
                // sum_j W[i][j] x_j over the key tiles j0 <= i0
                for (int jt = 0; jt <= it; ++jt) {
                    const int j0 = 16 * jt;
                    if (j0 >= q) break;
                    // G = C . B^T, even and odd k steps in separate chains
                    float s[2][4], s2[2][4];
#pragma unroll
                    for (int nb = 0; nb < 2; ++nb)
#pragma unroll
                        for (int e = 0; e < 4; ++e) s[nb][e] = s2[nb][e] = 0.f;
#pragma unroll
                    for (int kk = 0; kk < N / 16; kk += 2) {
                        uint32_t bk[4], bk2[4];
                        const int o = (j0 + k_off_r) * LDN + kk * 16 + k_off_c;
                        ldsm_x4(bk, smem_addr(Bs + o));
                        ldsm_x4(bk2, smem_addr(Bs + o + 16));
                        mma_bf16(s[0], cf[kk], bk[0], bk[1]);
                        mma_bf16(s[1], cf[kk], bk[2], bk[3]);
                        mma_bf16(s2[0], cf[kk + 1], bk2[0], bk2[1]);
                        mma_bf16(s2[1], cf[kk + 1], bk2[2], bk2[3]);
                    }
#pragma unroll
                    for (int nb = 0; nb < 2; ++nb)
#pragma unroll
                        for (int e = 0; e < 4; ++e) s[nb][e] += s2[nb][e];
                    // W in registers, re-packed as the A operand of W . x:
                    // a[0] / a[1] rows gr / gr + 8 of keys j0 .. j0 + 7, a[2] /
                    // a[3] of keys j0 + 8 .. j0 + 15
                    // Branch-free: a masked pair's exponent is -inf (ex2 of
                    // it is +0), and only the diagonal tile has masked pairs.
                    uint32_t wh[4], wl[4];
                    const bool diag = jt == it;
#pragma unroll
                    for (int nb = 0; nb < 2; ++nb) {
                        const int j = j0 + 8 * nb + 2 * tq;
                        const float cj0 = cums[j], cj1 = cums[j + 1];
                        const float d0 = dts[j], d1 = dts[j + 1];
                        float x00 = c0 - cj0, x01 = c0 - cj1, x10 = c1 - cj0, x11 = c1 - cj1;
                        if (diag) {
                            x00 = j <= r0 ? x00 : -INFINITY;
                            x01 = j + 1 <= r0 ? x01 : -INFINITY;
                            x10 = j <= r1 ? x10 : -INFINITY;
                            x11 = j + 1 <= r1 ? x11 : -INFINITY;
                        }
                        split2(s[nb][0] * __expf(x00) * d0, s[nb][1] * __expf(x01) * d1,
                               wh[2 * nb], wl[2 * nb]);
                        split2(s[nb][2] * __expf(x10) * d0, s[nb][3] * __expf(x11) * d1,
                               wh[2 * nb + 1], wl[2 * nb + 1]);
                    }
#pragma unroll
                    for (int pb = 0; pb < PB; ++pb) {
                        uint32_t bx[4];
                        ldsm_x4_trans(bx, smem_addr(Xs + (j0 + v_off_r) * LDP + pb * 16 + v_off_c));
                        mma_bf16(acc[2 * pb], wh, bx[0], bx[1]);
                        mma_bf16(acl[2 * pb], wl, bx[0], bx[1]);
                        mma_bf16(acc[2 * pb + 1], wh, bx[2], bx[3]);
                        mma_bf16(acl[2 * pb + 1], wl, bx[2], bx[3]);
                    }
                }
#pragma unroll
                for (int j = 0; j < PT / 8; ++j)
#pragma unroll
                    for (int e = 0; e < 4; ++e) acc[j][e] += acl[j][e];
                // y rows r0 and r1, rounded to bf16 once
#pragma unroll
                for (int j = 0; j < PT / 8; ++j) {
                    const int p = p0 + 8 * j + 2 * tq;
                    if (r0 < q)
                        *reinterpret_cast<uint32_t*>(y + ((tok0 + r0) * H + h) * P + p) =
                            pack_bf16(acc[j][0], acc[j][1]);
                    if (r1 < q)
                        *reinterpret_cast<uint32_t*>(y + ((tok0 + r1) * H + h) * P + p) =
                            pack_bf16(acc[j][2], acc[j][3]);
                }
            }
        }

        // (x_j wend_j)^T as bf16 hi + lo, U[p][j], the A operand of the
        // state product
        for (int i = tid; i < PT * (Q / 2); i += kThreads) {
            const int p = i % PT, j = (i / PT) * 2;     // a warp reads along a row of x
            const float u0 = __bfloat162float(Xs[j * LDP + p]) * wend[j];
            const float u1 = __bfloat162float(Xs[(j + 1) * LDP + p]) * wend[j + 1];
            uint32_t hi, lo;
            split2(u0, u1, hi, lo);
            *reinterpret_cast<uint32_t*>(Uhi + p * LDQ + j) = hi;
            *reinterpret_cast<uint32_t*>(Ulo + p * LDQ + j) = lo;
        }
        __syncthreads();        // U is written; every y product is done with H

        // h = exp(cums_last) h + U . B over the chunk's tokens, on the
        // warp's own columns
        const float decay = ecum[Q - 1];        // padding keeps cums at cums[q - 1]
#pragma unroll
        for (int mt = 0; mt < MS; ++mt)
#pragma unroll
            for (int nb = 0; nb < NBW; ++nb)
#pragma unroll
                for (int e = 0; e < 4; ++e) st[mt][nb][e] *= decay;
        for (int kk = 0; kk < Q / 16; ++kk) {
            if (kk * 16 >= q) break;
            uint32_t uh[MS][4], ul[MS][4];
#pragma unroll
            for (int mt = 0; mt < MS; ++mt) {
                const int o = (16 * mt + a_off_r) * LDQ + kk * 16 + a_off_c;
                ldsm_x4(uh[mt], smem_addr(Uhi + o));
                ldsm_x4(ul[mt], smem_addr(Ulo + o));
            }
#pragma unroll
            for (int nb2 = 0; nb2 < NBW / 2; ++nb2) {
                uint32_t bb[4];
                ldsm_x4_trans(bb, smem_addr(Bs + (kk * 16 + v_off_r) * LDN + nw0 + nb2 * 16 +
                                            v_off_c));
#pragma unroll
                for (int mt = 0; mt < MS; ++mt) {
                    mma_bf16(st[mt][2 * nb2], uh[mt], bb[0], bb[1]);
                    mma_bf16(st[mt][2 * nb2], ul[mt], bb[0], bb[1]);
                    mma_bf16(st[mt][2 * nb2 + 1], uh[mt], bb[2], bb[3]);
                    mma_bf16(st[mt][2 * nb2 + 1], ul[mt], bb[2], bb[3]);
                }
            }
        }
        split_state();          // read by the next chunk's y, past its first barrier
    }
    cp_async_wait<0>();

#pragma unroll
    for (int mt = 0; mt < MS; ++mt)
#pragma unroll
        for (int nb = 0; nb < NBW; ++nb) {
            const int64_t o = soff + (int64_t)(p0 + 16 * mt + gr) * N + nw0 + 8 * nb + 2 * tq;
            *reinterpret_cast<float2*>(hout + o) = make_float2(st[mt][nb][0], st[mt][nb][1]);
            *reinterpret_cast<float2*>(hout + o + 8 * N) =
                make_float2(st[mt][nb][2], st[mt][nb][3]);
        }
}

// One decode step (L = 1): each warp streams kDecodeRows rows (h, p) of the
// state, four floats a lane per 16-byte load:
//   h_new = exp(dt A) h + (dt x_p) B,  y_p = C . h_new,
// fp32 throughout, y rounded to bf16 once.
__global__ void __launch_bounds__(32 * kDecodeWarps)
ssd_decode_kernel(const bf16* __restrict__ x, const float* __restrict__ dt,
                  const float* __restrict__ A, const bf16* __restrict__ Bm,
                  const bf16* __restrict__ Cm, const float* __restrict__ h0,
                  bf16* __restrict__ y, float* __restrict__ hout, int H, int P, int N) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, b = blockIdx.y;
    const int rows = H * P;
    const int row0 = (blockIdx.x * kDecodeWarps + warp) * kDecodeRows;
    float e[kDecodeRows], u[kDecodeRows], part[kDecodeRows];
    int64_t off[kDecodeRows];
#pragma unroll
    for (int r = 0; r < kDecodeRows; ++r) {
        const int row = min(row0 + r, rows - 1);
        const int hh = row / P;
        const float d = dt[(int64_t)b * H + hh];
        e[r] = expf(d * A[hh]);
        u[r] = d * __bfloat162float(x[(int64_t)b * rows + row]);
        off[r] = ((int64_t)b * rows + row) * N;
        part[r] = 0.f;
    }
    const bf16* Bb = Bm + (int64_t)b * N;
    const bf16* Cb = Cm + (int64_t)b * N;
    for (int n = 4 * lane; n < N; n += 128) {
        float4 hv[kDecodeRows];
#pragma unroll
        for (int r = 0; r < kDecodeRows; ++r)
            hv[r] = h0 && row0 + r < rows ? *reinterpret_cast<const float4*>(h0 + off[r] + n)
                                          : make_float4(0.f, 0.f, 0.f, 0.f);
        const uint2 braw = *reinterpret_cast<const uint2*>(Bb + n);
        const uint2 craw = *reinterpret_cast<const uint2*>(Cb + n);
        const float2 b01 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&braw.x));
        const float2 b23 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&braw.y));
        const float2 c01 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&craw.x));
        const float2 c23 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&craw.y));
#pragma unroll
        for (int r = 0; r < kDecodeRows; ++r) {
            if (row0 + r >= rows) continue;
            float4 hn;
            hn.x = fmaf(e[r], hv[r].x, u[r] * b01.x);
            hn.y = fmaf(e[r], hv[r].y, u[r] * b01.y);
            hn.z = fmaf(e[r], hv[r].z, u[r] * b23.x);
            hn.w = fmaf(e[r], hv[r].w, u[r] * b23.y);
            *reinterpret_cast<float4*>(hout + off[r] + n) = hn;
            part[r] += c01.x * hn.x + c01.y * hn.y + c23.x * hn.z + c23.y * hn.w;
        }
    }
#pragma unroll
    for (int r = 0; r < kDecodeRows; ++r) {
        float s = part[r];
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
        if (lane == 0 && row0 + r < rows) y[(int64_t)b * rows + row0 + r] = __float2bfloat16_rn(s);
    }
}

template <int N, int PT>
cudaError_t launch_chunks(const void* x, const float* dt, const float* A, const void* Bm,
                          const void* Cm, const float* h0, void* y, float* hout, int B, int L,
                          int H, int P, cudaStream_t stream) {
    constexpr int smem = Tile<N, PT>::BYTES;
    static bool opted_in = false;       // above 48 KB only after opting in
    if (!opted_in) {
        cudaError_t e = cudaFuncSetAttribute(
            ssd_chunk_kernel<N, PT>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (e != cudaSuccess) return e;
        opted_in = true;
    }
    const dim3 grid(H, P / PT, B);
    ssd_chunk_kernel<N, PT><<<grid, kThreads, smem, stream>>>(
        static_cast<const bf16*>(x), dt, A, static_cast<const bf16*>(Bm),
        static_cast<const bf16*>(Cm), h0, static_cast<bf16*>(y), hout, L, H, P);
    return cudaGetLastError();
}

template <int N>
cudaError_t launch_n(const void* x, const float* dt, const float* A, const void* Bm,
                     const void* Cm, const float* h0, void* y, float* hout, int B, int L, int H,
                     int P, cudaStream_t stream) {
    if (P % 32 == 0)
        return launch_chunks<N, 32>(x, dt, A, Bm, Cm, h0, y, hout, B, L, H, P, stream);
    return launch_chunks<N, 16>(x, dt, A, Bm, Cm, h0, y, hout, B, L, H, P, stream);
}

cudaError_t launch(const void* x, const float* dt, const float* A, const void* Bm,
                   const void* Cm, const float* h0, void* y, float* hout, int B, int L, int H,
                   int P, int N, cudaStream_t stream) {
    if (L == 1) {
        const int per_block = kDecodeWarps * kDecodeRows;
        const dim3 grid((H * P + per_block - 1) / per_block, B);
        ssd_decode_kernel<<<grid, 32 * kDecodeWarps, 0, stream>>>(
            static_cast<const bf16*>(x), dt, A, static_cast<const bf16*>(Bm),
            static_cast<const bf16*>(Cm), h0, static_cast<bf16*>(y), hout, H, P, N);
        return cudaGetLastError();
    }
    switch (N) {
        case 64: return launch_n<64>(x, dt, A, Bm, Cm, h0, y, hout, B, L, H, P, stream);
        case 128: return launch_n<128>(x, dt, A, Bm, Cm, h0, y, hout, B, L, H, P, stream);
        case 256: return launch_n<256>(x, dt, A, Bm, Cm, h0, y, hout, B, L, H, P, stream);
        default: return cudaErrorInvalidValue;
    }
}

}  // namespace tc

// ---------------------------------------------------------------------------
// Backward: three launches on the caller's stream on either route,
// deterministic (no floating-point atomics; every sum over blocks is a
// second pass in a fixed order).
//
// The CUDA-core route (float32; bfloat16 at other P or N) is fp32
// arithmetic through cc::tile_product: state_pass_kernel, chunk_kernel
// (one block per (head, chunk, batch row)) and reduce_kernel.
//
// The tensor-core route (bfloat16, P a multiple of 16, N = 64, 128 or 256:
// mamba2-1.3b trains on it at H = 64, P = 64, N = 128):
//   - Chunks of Q = 64 tokens (32 at N = 256).  The states' scratch, two
//     (B, nc, H, P, N) arrays of fp32 bytes, is this design's main cost in
//     bytes: 268 MB each at (2, 4096) x 64 heads, written once and read
//     once.  Q = 128 would halve it but give the chunk kernel 64 blocks at
//     that shape, half the SMs, for the same work a block; Q = 64 gives
//     128 blocks, one wave on 132 SMs, and a chunk's tiles fit shared
//     memory two stages deep.
//   - tc_state_pass_kernel: the forward's tensor-core chunk walk
//     (tc::ssd_chunk_kernel) without y: one block of 4 warps per (head,
//     slab of PT = 32 state rows (16 where P is not a multiple of 32),
//     batch row) and direction (blockIdx.z), the slab of the state in fp32
//     registers (a warp owns N / 4 columns), a chunk's B or C (Q x N), x or
//     dy (Q x PT) and dt staged by cp.async two deep.  Per chunk it writes
//     the state (or adjoint) at the chunk's boundary as a bf16 hi plane and
//     a lo plane (the bytes of the fp32 state, in the form the chunk kernel
//     reads), then h = exp(cums_last) h + U . V on mma.sync.m16n8k16 fed by
//     ldmatrix, U = x wend dt or dy exp(cums) (fp32, scaled before the
//     product) as a hi + lo pair, V = B or C exact.
//   - tc_chunk_kernel: one block of 8 warps per (chunk, batch row), the
//     heads walked in ascending order, each head's P in slabs of PS rows
//     (32; 64 at N = 64), "units" staged by cp.async two deep: x and dy (Q
//     x PS), h_prev and dh hi + lo (PS x N), dt.  Per chunk: C and B
//     staged once, G = C . B^T formed once into registers (exact operands,
//     a warp's 16 x 16 tiles of the lower triangle).  Per head: its
//     cumsum, W = G exp(cums_i - cums_j) dt_j (the mask a select) into
//     shared memory as hi + lo; per unit dW += dy . x^T (exact), the state
//     terms v = exp(cums_i) dy . h_prev and exp(cums_last - cums_j) x . dh
//     (h_prev, dh as hi + lo; rows scaled after the product) added to the
//     chunk's dC and dB accumulators (registers: each element always in
//     the same thread, heads in order) and dotted with C and B into S and
//     T, dh . h_prev, and dx = W^T . dy + wend dt (B . dh^T) for the slab's
//     columns (W, dh as hi + lo), stored bf16.  After the head's units: dG
//     = dW exp(..) dt_j added into the block's sum over heads (registers,
//     head order), E = dW G exp(..) into rowR and colE; partial sums of
//     rowR, colE, S, T and dh . h_prev per warp in shared memory, summed in
//     a fixed order by warp 0, which forms d(cums), its reversed cumsum
//     (shuffles), ddt and the head's share of dA.  After the last head:
//     dC += (sum dG) . B and dB += (sum dG)^T . C once, sum dG as hi + lo,
//     and dC, dB stored bf16.  No pB or pC: the sum over heads never
//     leaves the block.
//   - Shared memory (BwdTile<N>; bf16 rows padded by 8 elements, so
//     ldmatrix meets no bank conflict): C, B, W hi + lo; two unit stages;
//     cums, exp(cums), exp(cums_last - cums) and the partial sums.  147 KB
//     at N = 128 (one block an SM, 8 warps), 151 KB at N = 64, 187 KB at
//     N = 256.  The passes (PassTile<N, PT>): 55 KB at N = 128, PT = 32.
//   - Split operands (a bf16 hi + lo pair, within 2^-16 of the fp32 value;
//     two MMAs per product): x wend dt and dy exp(cums) in the passes; the
//     states and adjoints (stored split); W; sum_h dG.  x, dy, B and C are
//     bf16 values and enter exact, as does every product of them alone (C
//     B^T, dy x^T).
//   - mma.sync rather than wgmma: the products are many small ones of
//     mixed layouts (A operands transposed out of W and sum dG, hi + lo
//     pairs, 16-row tiles spread over 8 warps by row and column), staged by
//     per-thread cp.async into padded tiles; wgmma's 64-row warpgroup
//     tiles want 128-byte-swizzled TMA layouts, which a later redesign can
//     give the Q x N products, the bulk of the work.
//   - Bound on the H100 at (2, 4096, 64, 64), N 128: the design moves ~1.4
//     GB (the states written and read, 1.07 GB; x and dy read twice, dx
//     written), 0.42 ms at 3.35 TB/s, and runs ~94 GFLOP of mma.sync with
//     the hi + lo products (~60 in the chunk kernel, ~34 in the passes),
//     0.095 ms at 989 TFLOP/s: bound by bytes, the states' scratch above
//     the function's own 214 MB (0.064 ms).  What keeps it from that:
//     mma.sync's issue rate and the ldmatrix -> mma chains of one block an
//     SM, the serial chunk walk of the passes (64 steps a block), and the
//     per-unit barriers of the chunk kernel.

namespace bwd {

using cc::kThreads;
using cc::odd;
using cc::tile_product;

constexpr int kMaxQ = 64;       // chunk length cap (one warp scans it, 2 tokens a lane)
constexpr int kSlab = 16;       // state rows a block of the state passes owns

// Inclusive cumsum of dt * A over a chunk of q <= 64 tokens, by warp 0,
// with rounded operations only (no contraction into fma), so every kernel
// of the backward computes the same bits from the same dt.
__device__ __forceinline__ void chunk_cums(const float* dtv, float a_h, int q, float* cums) {
    const int lane = threadIdx.x;
    if (lane >= 32) return;
    const int t = 2 * lane;
    const float d0 = t < q ? __fmul_rn(dtv[t], a_h) : 0.f;
    const float d1 = t + 1 < q ? __fmul_rn(dtv[t + 1], a_h) : 0.f;
    const float pair = __fadd_rn(d0, d1);
    float s = pair;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
        const float v = __shfl_up_sync(0xffffffffu, s, off);
        if (lane >= off) s = __fadd_rn(s, v);
    }
    const float before = __fsub_rn(s, pair);
    if (t < q) cums[t] = __fadd_rn(before, d0);
    if (t + 1 < q) cums[t + 1] = s;
}

// Shared memory of the state passes, in floats.
struct PassLayout {
    int ldN, Vs, Us, St, dtv, cums, coef, total;
    __host__ __device__ PassLayout(int N, int Q) {
        ldN = odd(N);
        Vs = 0;                 // Vs[j][n]: the chunk's B (forward) or C (reverse)
        Us = Vs + Q * ldN;      // Us[j][p]: x_j wend_j (forward) or dy_j exp(cums_j) (reverse)
        St = Us + Q * kSlab;    // St[p][n]: the slab of the state or of its adjoint
        dtv = St + kSlab * ldN;
        cums = dtv + Q;
        coef = cums + Q;
        total = coef + Q;
    }
};

// Shared memory of the chunk kernel, in floats.
struct ChunkLayout {
    int ldN, ldP, ldQ;
    int Cs, Bs, Xs, Ys, Dh, Wm, Gm, Em, Tmp, dtv, cums, ecum, wend, rowR, colE, Sd, Td, dcum, red,
        total;
    __host__ __device__ ChunkLayout(int P, int N, int Q) {
        ldN = odd(N);
        ldP = odd(P);
        ldQ = odd(Q);
        Cs = 0;                 // Cs[i][n]
        Bs = Cs + Q * ldN;      // Bs[j][n]
        Xs = Bs + Q * ldN;      // Xs[j][p]
        Ys = Xs + Q * ldP;      // Ys[i][p]: dy
        Dh = Ys + Q * ldP;      // Dh[p][n]: the adjoint of the state leaving the chunk
        Wm = Dh + P * ldN;      // Wm[i][j]: G, then W
        Gm = Wm + Q * ldQ;      // Gm[i][j]: dG
        Em = Gm + Q * ldQ;      // Em[i][j]: dW_ij G_ij exp(cums_i - cums_j)
        Tmp = Em + Q * ldQ;     // Tmp[i][n]: the state terms of dC, then of dB
        dtv = Tmp + Q * ldN;
        cums = dtv + Q;
        ecum = cums + Q;        // exp(cums_i)
        wend = ecum + Q;        // exp(cums_last - cums_j), without dt_j
        rowR = wend + Q;
        colE = rowR + Q;
        Sd = colE + Q;          // dy_i . (the state's share of y_i)
        Td = Sd + Q;            // exp(cums_last - cums_j) x_j . (dh B_j)
        dcum = Td + Q;
        red = dcum + Q;         // kThreads partial sums of dh . h_prev
        total = red + kThreads;
    }
};

// blockIdx.x = head * slabs + slab, blockIdx.y = batch row, blockIdx.z =
// 0: the state entering each chunk, walked forwards from h0, into hs;
// 1: the adjoint of the state leaving each chunk, walked backwards from
//    dh_final, into dhs, and what is left after the first chunk into dh0.
template <typename T>
__global__ void __launch_bounds__(kThreads) state_pass_kernel(
    const T* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ A,
    const T* __restrict__ Bm, const T* __restrict__ Cm, const float* __restrict__ h0,
    const T* __restrict__ dy, const float* __restrict__ dh_final, float* __restrict__ hs,
    float* __restrict__ dhs, float* __restrict__ dh0, int L, int H, int P, int N, int Q) {
    extern __shared__ float smem[];
    const PassLayout lay(N, Q);
    float* Vs = smem + lay.Vs;
    float* Us = smem + lay.Us;
    float* St = smem + lay.St;
    float* dtv = smem + lay.dtv;
    float* cums = smem + lay.cums;
    float* coef = smem + lay.coef;
    const int ldN = lay.ldN, tid = threadIdx.x;
    const int slabs = (P + kSlab - 1) / kSlab;
    const int h = blockIdx.x / slabs, p0 = (blockIdx.x % slabs) * kSlab;
    const int b = blockIdx.y;
    const bool reverse = blockIdx.z == 1;
    const int ps = min(kSlab, P - p0);
    const int nc = (L + Q - 1) / Q;
    const float a_h = A[h];
    const float* init = reverse ? dh_final : h0;
    float* out = reverse ? dhs : hs;
    const T* u_src = reverse ? dy : x;
    const T* v_src = reverse ? Cm : Bm;
    const int64_t soff = ((int64_t)b * H + h) * P * N + (int64_t)p0 * N;

    for (int idx = tid; idx < ps * N; idx += kThreads) {
        const int p = idx / N, n = idx - p * N;
        St[p * ldN + n] = init ? init[soff + idx] : 0.f;
    }
    for (int k = 0; k < nc; ++k) {
        const int c = reverse ? nc - 1 - k : k;
        const int t0 = c * Q, q = min(Q, L - t0);
        const int64_t tok0 = (int64_t)b * L + t0;
        __syncthreads();        // the previous chunk's readers are done
        // the state (or adjoint) at this chunk's boundary, each thread its own elements
        float* o = out + (((int64_t)b * nc + c) * H + h) * P * N + (int64_t)p0 * N;
        for (int idx = tid; idx < ps * N; idx += kThreads) {
            const int p = idx / N, n = idx - p * N;
            o[idx] = St[p * ldN + n];
        }
        for (int j = tid; j < q; j += kThreads) dtv[j] = dt[(tok0 + j) * H + h];
        for (int idx = tid; idx < q * N; idx += kThreads) {
            const int j = idx / N, n = idx - j * N;
            Vs[j * ldN + n] = to_float(v_src[(tok0 + j) * N + n]);
        }
        __syncthreads();
        chunk_cums(dtv, a_h, q, cums);
        __syncthreads();
        const float last = cums[q - 1];
        for (int j = tid; j < q; j += kThreads)
            coef[j] = reverse ? expf(cums[j]) : expf(last - cums[j]) * dtv[j];
        __syncthreads();
        for (int idx = tid; idx < q * ps; idx += kThreads) {
            const int j = idx / ps, p = idx - j * ps;
            Us[j * kSlab + p] = to_float(u_src[((tok0 + j) * H + h) * P + p0 + p]) * coef[j];
        }
        __syncthreads();
        const float decay = expf(last);
        for (int idx = tid; idx < ps * N; idx += kThreads) {
            const int p = idx / N, n = idx - p * N;
            float acc = 0.f;
            for (int j = 0; j < q; ++j) acc = fmaf(Us[j * kSlab + p], Vs[j * ldN + n], acc);
            float& s = St[p * ldN + n];
            s = fmaf(s, decay, acc);
        }
    }
    if (reverse && dh0) {
        for (int idx = tid; idx < ps * N; idx += kThreads) {
            const int p = idx / N, n = idx - p * N;
            dh0[soff + idx] = St[p * ldN + n];
        }
    }
}

// One block per (head, chunk, batch row): every gradient term of the chunk
// for that head.  dx and ddt are written whole; the head's share of dBm and
// dCm goes to pB, pC (B, L, H, N) fp32 and its share of dA to pA (B, nc, H),
// which reduce_kernel sums over heads (and chunks) in a fixed order.
template <typename T>
__global__ void __launch_bounds__(kThreads) chunk_kernel(
    const T* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ A,
    const T* __restrict__ Bm, const T* __restrict__ Cm, const T* __restrict__ dy,
    const float* __restrict__ hs, const float* __restrict__ dhs, T* __restrict__ dx,
    float* __restrict__ ddt, float* __restrict__ pA, float* __restrict__ pB,
    float* __restrict__ pC, int L, int H, int P, int N, int Q) {
    extern __shared__ float smem[];
    const ChunkLayout lay(P, N, Q);
    float* Cs = smem + lay.Cs;
    float* Bs = smem + lay.Bs;
    float* Xs = smem + lay.Xs;
    float* Ys = smem + lay.Ys;
    float* Dh = smem + lay.Dh;
    float* Wm = smem + lay.Wm;
    float* Gm = smem + lay.Gm;
    float* Em = smem + lay.Em;
    float* Tmp = smem + lay.Tmp;
    float* dtv = smem + lay.dtv;
    float* cums = smem + lay.cums;
    float* ecum = smem + lay.ecum;
    float* wend = smem + lay.wend;
    float* rowR = smem + lay.rowR;
    float* colE = smem + lay.colE;
    float* Sv = smem + lay.Sd;
    float* Tv = smem + lay.Td;
    float* dcum = smem + lay.dcum;
    float* red = smem + lay.red;
    const int ldN = lay.ldN, ldP = lay.ldP, ldQ = lay.ldQ, tid = threadIdx.x;
    const int h = blockIdx.x, c = blockIdx.y, b = blockIdx.z;
    const int nc = (L + Q - 1) / Q;
    const int t0 = c * Q, q = min(Q, L - t0);
    const int64_t tok0 = (int64_t)b * L + t0;
    const float a_h = A[h];
    const int64_t st_off = (((int64_t)b * nc + c) * H + h) * P * N;
    const float* hp = hs + st_off;          // the state entering the chunk
    const float* dhg = dhs + st_off;        // the adjoint of the state leaving it

    for (int j = tid; j < q; j += kThreads) dtv[j] = dt[(tok0 + j) * H + h];
    for (int idx = tid; idx < q * N; idx += kThreads) {
        const int j = idx / N, n = idx - j * N;
        const int64_t g = (tok0 + j) * N + n;
        Cs[j * ldN + n] = to_float(Cm[g]);
        Bs[j * ldN + n] = to_float(Bm[g]);
    }
    for (int idx = tid; idx < q * P; idx += kThreads) {
        const int j = idx / P, p = idx - j * P;
        const int64_t g = ((tok0 + j) * H + h) * P + p;
        Xs[j * ldP + p] = to_float(x[g]);
        Ys[j * ldP + p] = to_float(dy[g]);
    }
    for (int idx = tid; idx < P * N; idx += kThreads) {
        const int p = idx / N, n = idx - p * N;
        Dh[p * ldN + n] = dhg[idx];
    }
    __syncthreads();
    chunk_cums(dtv, a_h, q, cums);
    __syncthreads();
    const float last = cums[q - 1];
    for (int j = tid; j < q; j += kThreads) {
        ecum[j] = expf(cums[j]);
        wend[j] = expf(last - cums[j]);
    }

    // G = C . B^T into Wm
    tile_product(
        q, q, N, [=](int i, int n) { return Cs[i * ldN + n]; },
        [=](int n, int j) { return Bs[j * ldN + n]; },
        [=](int i, int j, float g) { Wm[i * ldQ + j] = g; });
    __syncthreads();
    // dW = dy . x^T; with G (same thread, same element) -> W, dG and E; the
    // mask is a select: a pair j > i never uses an exponential
    tile_product(
        q, q, P, [=](int i, int p) { return Ys[i * ldP + p]; },
        [=](int p, int j) { return Xs[j * ldP + p]; },
        [=](int i, int j, float dw) {
            const float g = Wm[i * ldQ + j];
            const float l = j <= i ? expf(cums[i] - cums[j]) : 0.f;
            Wm[i * ldQ + j] = g * l * dtv[j];
            Gm[i * ldQ + j] = dw * l * dtv[j];
            Em[i * ldQ + j] = dw * g * l;
        });
    __syncthreads();
    for (int i = tid; i < q; i += kThreads) {
        float r = 0.f, e = 0.f;
        for (int j = 0; j <= i; ++j) r = fmaf(Em[i * ldQ + j], dtv[j], r);
        for (int k = i; k < q; ++k) e += Em[k * ldQ + i];
        rowR[i] = r;
        colE[i] = e;
    }

    // dx_j = sum_i W_ij dy_i + exp(cums_last - cums_j) dt_j (dh B_j), depth q + N
    tile_product(
        q, P, q + N,
        [=](int j, int k) {
            return k < q ? Wm[k * ldQ + j] : Bs[j * ldN + (k - q)] * wend[j] * dtv[j];
        },
        [=](int k, int p) { return k < q ? Ys[k * ldP + p] : Dh[p * ldN + (k - q)]; },
        [=](int j, int p, float v) { dx[((tok0 + j) * H + h) * P + p] = from_float<T>(v); });

    // dC: the state's term exp(cums_i) h_prev^T dy_i into Tmp, its dot with
    // C_i (the exponent's adjoint S_i), then + sum_j dG_ij B_j
    tile_product(
        q, N, P, [=](int i, int p) { return Ys[i * ldP + p] * ecum[i]; },
        [=](int p, int n) { return hp[(int64_t)p * N + n]; },
        [=](int i, int n, float v) { Tmp[i * ldN + n] = v; });
    __syncthreads();
    for (int i = tid; i < q; i += kThreads) {
        float s = 0.f;
        for (int n = 0; n < N; ++n) s = fmaf(Cs[i * ldN + n], Tmp[i * ldN + n], s);
        Sv[i] = s;
    }
    tile_product(
        q, N, q, [=](int i, int j) { return Gm[i * ldQ + j]; },
        [=](int j, int n) { return Bs[j * ldN + n]; },
        [=](int i, int n, float v) {
            pC[((tok0 + i) * H + h) * N + n] = Tmp[i * ldN + n] + v;
        });
    __syncthreads();
    // dB: the state's term exp(cums_last - cums_j) dh^T x_j (dt_j apart)
    // into Tmp, its dot with B_j (T_j), then dt_j Tmp + sum_i dG_ij C_i
    tile_product(
        q, N, P, [=](int j, int p) { return Xs[j * ldP + p] * wend[j]; },
        [=](int p, int n) { return Dh[p * ldN + n]; },
        [=](int j, int n, float v) { Tmp[j * ldN + n] = v; });
    __syncthreads();
    for (int j = tid; j < q; j += kThreads) {
        float s = 0.f;
        for (int n = 0; n < N; ++n) s = fmaf(Bs[j * ldN + n], Tmp[j * ldN + n], s);
        Tv[j] = s;
    }
    tile_product(
        q, N, q, [=](int j, int i) { return Gm[i * ldQ + j]; },
        [=](int i, int n) { return Cs[i * ldN + n]; },
        [=](int j, int n, float v) {
            pB[((tok0 + j) * H + h) * N + n] = fmaf(Tmp[j * ldN + n], dtv[j], v);
        });

    // dh . h_prev, each thread a fixed strided share, then a fixed tree
    float part = 0.f;
    for (int idx = tid; idx < P * N; idx += kThreads) {
        const int p = idx / N, n = idx - p * N;
        part = fmaf(Dh[p * ldN + n], hp[idx], part);
    }
    red[tid] = part;
    __syncthreads();
    for (int w = kThreads / 2; w > 0; w >>= 1) {
        if (tid < w) red[tid] += red[tid + w];
        __syncthreads();
    }
    // d(cums), its reversed cumsum d(dt A), then ddt and this block's dA
    if (tid == 0) {
        float tail = red[0] * ecum[q - 1];
        for (int j = 0; j < q; ++j) tail = fmaf(dtv[j], Tv[j], tail);
        for (int i = 0; i < q; ++i)
            dcum[i] = rowR[i] - colE[i] * dtv[i] + Sv[i] - dtv[i] * Tv[i] + (i == q - 1 ? tail : 0.f);
        float da = 0.f, sum_a = 0.f;
        for (int t = q - 1; t >= 0; --t) {
            da += dcum[t];
            ddt[(tok0 + t) * H + h] = colE[t] + Tv[t] + a_h * da;
            sum_a = fmaf(dtv[t], da, sum_a);
        }
        pA[((int64_t)b * nc + c) * H + h] = sum_a;
    }
}

// dBm, dCm (b, t, n) = the sum over heads of pB, pC in head order; dA (h) =
// the sum of pA over batch rows and chunks in order.
template <typename T>
__global__ void __launch_bounds__(kThreads) reduce_kernel(
    const float* __restrict__ pA, const float* __restrict__ pB, const float* __restrict__ pC,
    float* __restrict__ dA, T* __restrict__ dB, T* __restrict__ dC, int64_t rows, int H, int N,
    int nA) {
    const int64_t idx = (int64_t)blockIdx.x * kThreads + threadIdx.x;
    if (idx < rows * N) {
        const int64_t r = idx / N, n = idx - r * N;
        const float* sb = pB + r * H * N + n;
        const float* sc = pC + r * H * N + n;
        float vb = 0.f, vc = 0.f;
        for (int h = 0; h < H; ++h) {
            vb += sb[(int64_t)h * N];
            vc += sc[(int64_t)h * N];
        }
        dB[idx] = from_float<T>(vb);
        dC[idx] = from_float<T>(vc);
    }
    if (idx < H) {
        float v = 0.f;
        for (int k = 0; k < nA; ++k) v += pA[(int64_t)k * H + idx];
        dA[idx] = v;
    }
}

int chunk_for(int L, int P, int N) {
    for (int Q = kMaxQ; Q >= 1; Q /= 2) {
        const int q = Q < L ? Q : L;
        if ((int64_t)ChunkLayout(P, N, q).total * 4 <= kMaxSmem &&
            (int64_t)PassLayout(N, q).total * 4 <= kMaxSmem)
            return q;
    }
    return 0;
}

template <class K>
cudaError_t opt_in(K kernel, int smem) {
    if (smem <= 48 * 1024) return cudaSuccess;      // above 48 KB only after opting in
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

template <typename T>
cudaError_t launch_typed(const void* x, const float* dt, const float* A, const void* Bm,
                         const void* Cm, const float* h0, const void* dy, const float* dh_final,
                         void* dx, float* ddt, float* dA, void* dB, void* dC, float* dh0,
                         float* hs, float* dhs, float* pA, float* pB, float* pC, int B, int L,
                         int H, int P, int N, cudaStream_t stream) {
    const int Q = chunk_for(L, P, N);
    if (Q == 0) return cudaErrorInvalidValue;
    const int nc = (L + Q - 1) / Q;
    if (nc > 65535) return cudaErrorInvalidValue;
    const T* xt = static_cast<const T*>(x);
    const T* bt = static_cast<const T*>(Bm);
    const T* ct = static_cast<const T*>(Cm);
    const T* dyt = static_cast<const T*>(dy);

    const int pass_smem = PassLayout(N, Q).total * (int)sizeof(float);
    cudaError_t e = opt_in(state_pass_kernel<T>, pass_smem);
    if (e != cudaSuccess) return e;
    const int slabs = (P + kSlab - 1) / kSlab;
    state_pass_kernel<T><<<dim3(H * slabs, B, 2), kThreads, pass_smem, stream>>>(
        xt, dt, A, bt, ct, h0, dyt, dh_final, hs, dhs, dh0, L, H, P, N, Q);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;

    const int chunk_smem = ChunkLayout(P, N, Q).total * (int)sizeof(float);
    if ((e = opt_in(chunk_kernel<T>, chunk_smem)) != cudaSuccess) return e;
    chunk_kernel<T><<<dim3(H, nc, B), kThreads, chunk_smem, stream>>>(
        xt, dt, A, bt, ct, dyt, hs, dhs, static_cast<T*>(dx), ddt, pA, pB, pC, L, H, P, N, Q);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;

    const int64_t rows = (int64_t)B * L;
    const int64_t work = rows * N > H ? rows * N : H;
    reduce_kernel<T><<<(unsigned)((work + kThreads - 1) / kThreads), kThreads, 0, stream>>>(
        pA, pB, pC, dA, static_cast<T*>(dB), static_cast<T*>(dC), rows, H, N, B * nc);
    return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Tensor-core route of the backward (bfloat16, P a multiple of 16, N = 64,
// 128 or 256: the forward's rule, route_of).  See the note above this
// namespace.

using tc::bf16;
using tc::cp_async16;
using tc::cp_async4;
using tc::cp_async_commit;
using tc::cp_async_wait;
using tc::ldsm_x4;
using tc::ldsm_x4_trans;
using tc::mma_bf16;
using tc::pack_bf16;
using tc::smem_addr;
using tc::split2;

constexpr int kTcWarps = 8;                     // warps of a chunk block
constexpr int kTcThreads = 32 * kTcWarps;
constexpr int kPassThreads = tc::kThreads;      // 4 warps, as the forward's chunk walk

// The chunk kernel's tiles at this N, in bytes.  A "unit" is one head's
// slab of PS rows of P.  bf16 rows are padded by 8 elements (16 bytes) so
// that ldmatrix meets no bank conflict.
template <int N>
struct BwdTile {
    static constexpr int Q = N > 128 ? 32 : 64;             // chunk length
    static constexpr int PS = N > 64 ? 32 : 64;             // rows of P a unit stages
    static constexpr int MT = Q / 16;                       // 16-row m-tiles of a chunk
    static constexpr int WN = kTcWarps / MT;                // warps sharing an m-tile
    static constexpr int NB = N / WN / 8;                   // 8-column blocks of a Q x N product a warp owns
    static constexpr int QT = MT * MT >= kTcWarps ? MT * MT / kTcWarps : 1;  // its 16 x 16 tiles of a Q x Q product
    static constexpr int QWARPS = MT * MT / QT;             // warps that own Q x Q tiles
    static constexpr int WQ = QWARPS / MT;                  // of them, those sharing an m-tile
    static constexpr int LDN = N + 8, LDS = PS + 8, LDQ = Q + 8;
    // per chunk: C, B; W (then sum_h dG) as hi + lo
    static constexpr int C_ = 0;
    static constexpr int B_ = C_ + Q * LDN * 2;
    static constexpr int WHI = B_ + Q * LDN * 2;
    static constexpr int WLO = WHI + Q * LDQ * 2;
    // two unit stages: x and dy (Q x PS), h_prev and dh hi + lo (PS x N), dt
    static constexpr int STG = WLO + Q * LDQ * 2;
    static constexpr int X_ = 0;
    static constexpr int Y_ = X_ + Q * LDS * 2;
    static constexpr int HHI = Y_ + Q * LDS * 2;
    static constexpr int HLO = HHI + PS * LDN * 2;
    static constexpr int DHI = HLO + PS * LDN * 2;
    static constexpr int DLO = DHI + PS * LDN * 2;
    static constexpr int DT_ = DLO + PS * LDN * 2;
    static constexpr int STAGE = DT_ + Q * 4;
    // per head: cums, exp(cums_i), exp(cums_last - cums_j); the partial sums
    // of rowR (per warp column group), colE (per m-tile), S and T (per warp
    // column group) and dh . h_prev (per warp)
    static constexpr int CUMS = STG + 2 * STAGE;
    static constexpr int ECUM = CUMS + Q * 4;
    static constexpr int WEND = ECUM + Q * 4;
    static constexpr int ROWR = WEND + Q * 4;
    static constexpr int COLE = ROWR + WQ * Q * 4;
    static constexpr int SP = COLE + MT * Q * 4;
    static constexpr int TP = SP + WN * Q * 4;
    static constexpr int RED = TP + WN * Q * 4;
    static constexpr int BYTES = RED + kTcWarps * 4;
    static_assert(NB % 2 == 0, "a warp's columns come in 16-column ldmatrix pairs");
    static_assert(MT * MT % QT == 0 && QWARPS <= kTcWarps, "Q x Q tiles over the warps");
    static_assert(BYTES <= kMaxSmem, "chunk tiles exceed shared memory");
};

// The state passes' tiles at this N and slab of PT state rows, in bytes:
// two stages of (B or C, x or dy, dt), the scaled U^T hi + lo, cums, coef.
template <int N, int PT>
struct PassTile {
    static constexpr int Q = BwdTile<N>::Q;
    static constexpr int LDN = N + 8, LDP = PT + 8, LDQ = Q + 8;
    static constexpr int V_ = 0;
    static constexpr int U_ = V_ + Q * LDN * 2;
    static constexpr int DT_ = U_ + Q * LDP * 2;
    static constexpr int STAGE = DT_ + Q * 4;
    static constexpr int UHI = 2 * STAGE;
    static constexpr int ULO = UHI + PT * LDQ * 2;
    static constexpr int CUMS = ULO + PT * LDQ * 2;
    static constexpr int COEF = CUMS + Q * 4;
    static constexpr int DECAY = COEF + Q * 4;
    static constexpr int BYTES = DECAY + 16;
    static_assert((N / 4) % 16 == 0, "a warp's state columns come in 16-column ldmatrix pairs");
    static_assert(BYTES <= kMaxSmem, "pass tiles exceed shared memory");
};

// ldmatrix row addresses (lane offsets), as the forward's: A from a row-major
// m x k array (rows lane & 15, column half lane >> 4); B from an n x k array,
// and A from a k x m array by .trans (rows (lane & 7) + 8 (lane >> 4), column
// half (lane >> 3) & 1); B from a k x n array by .trans (rows (lane & 7) + 8
// ((lane >> 3) & 1), column half lane >> 4).
struct Lanes {
    int a_r, a_c, nk_r, nk_c, kn_r, kn_c;
    __device__ __forceinline__ explicit Lanes(int lane)
        : a_r(lane & 15), a_c((lane >> 4) << 3), nk_r((lane & 7) + ((lane >> 4) << 3)),
          nk_c(((lane >> 3) & 1) << 3), kn_r((lane & 7) + (((lane >> 3) & 1) << 3)),
          kn_c((lane >> 4) << 3) {}
};

// blockIdx.x = head * (P / PT) + slab, blockIdx.y = batch row, blockIdx.z =
// 0: the state entering each chunk, walked forwards from h0, into hs;
// 1: the adjoint of the state leaving each chunk, walked backwards from
//    dh_final, into dhs, and what is left after the first chunk into dh0
//    (fp32).
// hs and dhs hold, per (b, chunk, head), the bf16 hi plane (P x N) and then
// the lo plane: the bytes of an fp32 (P, N) state.
template <int N, int PT>
__global__ void __launch_bounds__(kPassThreads) tc_state_pass_kernel(
    const bf16* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ A,
    const bf16* __restrict__ Bm, const bf16* __restrict__ Cm, const float* __restrict__ h0,
    const bf16* __restrict__ dy, const float* __restrict__ dh_final, bf16* __restrict__ hs,
    bf16* __restrict__ dhs, float* __restrict__ dh0, int L, int H, int P) {
    using T = PassTile<N, PT>;
    constexpr int Q = T::Q, LDN = T::LDN, LDP = T::LDP, LDQ = T::LDQ;
    constexpr int NW = N / 4, NBW = NW / 8, MS = PT / 16;
    extern __shared__ __align__(16) unsigned char tc_smem[];
    bf16* Uhi = reinterpret_cast<bf16*>(tc_smem + T::UHI);
    bf16* Ulo = reinterpret_cast<bf16*>(tc_smem + T::ULO);
    float* cums = reinterpret_cast<float*>(tc_smem + T::CUMS);
    float* coef = reinterpret_cast<float*>(tc_smem + T::COEF);
    float* decay_s = reinterpret_cast<float*>(tc_smem + T::DECAY);

    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int gr = lane >> 2, tq = lane & 3;
    const int slabs = P / PT;
    const int h = blockIdx.x / slabs, p0 = (blockIdx.x - h * slabs) * PT, b = blockIdx.y;
    const bool reverse = blockIdx.z == 1;
    const float a_h = A[h];
    const int nc = (L + Q - 1) / Q;
    const int nw0 = warp * NW;
    const float* init = reverse ? dh_final : h0;
    bf16* out = reverse ? dhs : hs;
    const bf16* usrc = reverse ? dy : x;
    const bf16* vsrc = reverse ? Cm : Bm;

    // copy the k-th chunk of the walk (C or B, dy or x, dt) into stage k & 1
    // (rows past L zero), spread over threads t0, t0 + nt, ...
    auto issue = [&](int k, int t0, int nt) {
        const int c = reverse ? nc - 1 - k : k;
        unsigned char* st = tc_smem + (k & 1) * T::STAGE;
        bf16* Vs = reinterpret_cast<bf16*>(st + T::V_);
        bf16* Us = reinterpret_cast<bf16*>(st + T::U_);
        float* dts = reinterpret_cast<float*>(st + T::DT_);
        const int q = min(Q, L - c * Q);
        const int64_t tok0 = (int64_t)b * L + (int64_t)c * Q;
        constexpr int NCH = N / 8, PCH = PT / 8;        // 16-byte chunks a row
        for (int i = t0; i < Q * NCH; i += nt) {
            const int r = i / NCH, c8 = (i - r * NCH) * 8;
            const bool ok = r < q;
            cp_async16(smem_addr(Vs + r * LDN + c8), vsrc + (tok0 + (ok ? r : 0)) * N + c8, ok);
        }
        for (int i = t0; i < Q * PCH; i += nt) {
            const int r = i / PCH, c8 = (i - r * PCH) * 8;
            const bool ok = r < q;
            cp_async16(smem_addr(Us + r * LDP + c8),
                       usrc + ((tok0 + (ok ? r : 0)) * H + h) * P + p0 + c8, ok);
        }
        for (int r = t0; r < Q; r += nt) {
            const bool ok = r < q;
            cp_async4(smem_addr(dts + r), dt + (tok0 + (ok ? r : 0)) * H + h, ok);
        }
    };
    issue(0, tid, kPassThreads);
    cp_async_commit();

    // the warp's columns of the slab, fp32, in registers for the whole walk
    const int64_t soff = ((int64_t)b * H + h) * P * N;
    float st[MS][NBW][4];
#pragma unroll
    for (int mt = 0; mt < MS; ++mt)
#pragma unroll
        for (int nb = 0; nb < NBW; ++nb) {
            const int64_t o = soff + (int64_t)(p0 + 16 * mt + gr) * N + nw0 + 8 * nb + 2 * tq;
            float2 v0 = make_float2(0.f, 0.f), v1 = v0;
            if (init) {
                v0 = *reinterpret_cast<const float2*>(init + o);
                v1 = *reinterpret_cast<const float2*>(init + o + 8 * N);
            }
            st[mt][nb][0] = v0.x;
            st[mt][nb][1] = v0.y;
            st[mt][nb][2] = v1.x;
            st[mt][nb][3] = v1.y;
        }
    const Lanes ln(lane);

    for (int k = 0; k < nc; ++k) {
        const int c = reverse ? nc - 1 - k : k;
        const int q = min(Q, L - c * Q);
        cp_async_wait<0>();     // chunk k has landed (this thread's copies)
        // past this barrier: every copy of chunk k is visible and every warp
        // is done with chunk k - 1 (its stage, U and coef are free)
        __syncthreads();
        const unsigned char* stg = tc_smem + (k & 1) * T::STAGE;
        const bf16* Vs = reinterpret_cast<const bf16*>(stg + T::V_);
        const bf16* Us = reinterpret_cast<const bf16*>(stg + T::U_);
        const float* dts = reinterpret_cast<const float*>(stg + T::DT_);
        if (warp != 0 && k + 1 < nc) issue(k + 1, tid - 32, kPassThreads - 32);
        cp_async_commit();

        // the state (or adjoint) at this chunk's boundary, as bf16 hi + lo
        bf16* o = out + (((int64_t)b * nc + c) * H + h) * (int64_t)P * N * 2;
#pragma unroll
        for (int mt = 0; mt < MS; ++mt)
#pragma unroll
            for (int nb = 0; nb < NBW; ++nb) {
                const int64_t e = (int64_t)(p0 + 16 * mt + gr) * N + nw0 + 8 * nb + 2 * tq;
                uint32_t hi, lo;
                split2(st[mt][nb][0], st[mt][nb][1], hi, lo);
                *reinterpret_cast<uint32_t*>(o + e) = hi;
                *reinterpret_cast<uint32_t*>(o + (int64_t)P * N + e) = lo;
                split2(st[mt][nb][2], st[mt][nb][3], hi, lo);
                *reinterpret_cast<uint32_t*>(o + e + 8 * N) = hi;
                *reinterpret_cast<uint32_t*>(o + (int64_t)P * N + e + 8 * N) = lo;
            }
        // warp 0: the chunk's cumsum (the chunk kernel's bits), then each
        // token's factor: exp(cums_last - cums_j) dt_j forwards, exp(cums_i)
        // backwards (0 on padding)
        if (warp == 0) {
            chunk_cums(dts, a_h, q, cums);
            __syncwarp();
            const float last = cums[q - 1];
            for (int j = lane; j < Q; j += 32)
                coef[j] = j < q ? (reverse ? expf(cums[j]) : expf(last - cums[j]) * dts[j]) : 0.f;
            if (lane == 0) *decay_s = expf(last);
        }
        __syncthreads();
        // U[p][j] = (x or dy)[j][p] coef_j as bf16 hi + lo, the A operand
        for (int i = tid; i < PT * (Q / 2); i += kPassThreads) {
            const int p = i % PT, j = (i / PT) * 2;
            const float u0 = __bfloat162float(Us[j * LDP + p]) * coef[j];
            const float u1 = __bfloat162float(Us[(j + 1) * LDP + p]) * coef[j + 1];
            uint32_t hi, lo;
            split2(u0, u1, hi, lo);
            *reinterpret_cast<uint32_t*>(Uhi + p * LDQ + j) = hi;
            *reinterpret_cast<uint32_t*>(Ulo + p * LDQ + j) = lo;
        }
        __syncthreads();
        const float decay = *decay_s;
#pragma unroll
        for (int mt = 0; mt < MS; ++mt)
#pragma unroll
            for (int nb = 0; nb < NBW; ++nb)
#pragma unroll
                for (int e = 0; e < 4; ++e) st[mt][nb][e] *= decay;
        // + U . V over the chunk's tokens, on the warp's own columns
        for (int kk = 0; kk < Q / 16; ++kk) {
            if (kk * 16 >= q) break;
            uint32_t uh[MS][4], ul[MS][4];
#pragma unroll
            for (int mt = 0; mt < MS; ++mt) {
                const int oo = (16 * mt + ln.a_r) * LDQ + kk * 16 + ln.a_c;
                ldsm_x4(uh[mt], smem_addr(Uhi + oo));
                ldsm_x4(ul[mt], smem_addr(Ulo + oo));
            }
#pragma unroll
            for (int nb2 = 0; nb2 < NBW / 2; ++nb2) {
                uint32_t bb[4];
                ldsm_x4_trans(bb, smem_addr(Vs + (kk * 16 + ln.kn_r) * LDN + nw0 + nb2 * 16 +
                                            ln.kn_c));
#pragma unroll
                for (int mt = 0; mt < MS; ++mt) {
                    mma_bf16(st[mt][2 * nb2], uh[mt], bb[0], bb[1]);
                    mma_bf16(st[mt][2 * nb2], ul[mt], bb[0], bb[1]);
                    mma_bf16(st[mt][2 * nb2 + 1], uh[mt], bb[2], bb[3]);
                    mma_bf16(st[mt][2 * nb2 + 1], ul[mt], bb[2], bb[3]);
                }
            }
        }
    }
    cp_async_wait<0>();
    if (reverse && dh0) {
#pragma unroll
        for (int mt = 0; mt < MS; ++mt)
#pragma unroll
            for (int nb = 0; nb < NBW; ++nb) {
                const int64_t o = soff + (int64_t)(p0 + 16 * mt + gr) * N + nw0 + 8 * nb + 2 * tq;
                *reinterpret_cast<float2*>(dh0 + o) = make_float2(st[mt][nb][0], st[mt][nb][1]);
                *reinterpret_cast<float2*>(dh0 + o + 8 * N) =
                    make_float2(st[mt][nb][2], st[mt][nb][3]);
            }
    }
}

// One block per (chunk, batch row), walking the heads in ascending order, each
// head's P in slabs of PS rows ("units", staged by cp.async two deep).
// Fragment layout of m16n8k16 (lane = 4 gr + tq): an output block c[0..1]
// holds row gr, columns 2 tq and 2 tq + 1; c[2..3] the same columns of row
// gr + 8.
template <int N>
__global__ void __launch_bounds__(kTcThreads, 1) tc_chunk_kernel(
    const bf16* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ A,
    const bf16* __restrict__ Bm, const bf16* __restrict__ Cm, const bf16* __restrict__ dy,
    const bf16* __restrict__ hs, const bf16* __restrict__ dhs, bf16* __restrict__ dx,
    float* __restrict__ ddt, float* __restrict__ pA, bf16* __restrict__ dB,
    bf16* __restrict__ dC, int L, int H, int P) {
    using T = BwdTile<N>;
    constexpr int Q = T::Q, PS = T::PS, MT = T::MT, WN = T::WN, NB = T::NB, QT = T::QT;
    constexpr int LDN = T::LDN, LDS = T::LDS, LDQ = T::LDQ;
    extern __shared__ __align__(16) unsigned char tc_smem[];
    bf16* Cs = reinterpret_cast<bf16*>(tc_smem + T::C_);
    bf16* Bs = reinterpret_cast<bf16*>(tc_smem + T::B_);
    bf16* Whi = reinterpret_cast<bf16*>(tc_smem + T::WHI);
    bf16* Wlo = reinterpret_cast<bf16*>(tc_smem + T::WLO);
    float* cums = reinterpret_cast<float*>(tc_smem + T::CUMS);
    float* ecum = reinterpret_cast<float*>(tc_smem + T::ECUM);
    float* wend = reinterpret_cast<float*>(tc_smem + T::WEND);
    float* rowRp = reinterpret_cast<float*>(tc_smem + T::ROWR);
    float* colEp = reinterpret_cast<float*>(tc_smem + T::COLE);
    float* Sp = reinterpret_cast<float*>(tc_smem + T::SP);
    float* Tp = reinterpret_cast<float*>(tc_smem + T::TP);
    float* red = reinterpret_cast<float*>(tc_smem + T::RED);

    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int gr = lane >> 2, tq = lane & 3;
    const int c = blockIdx.x, b = blockIdx.y;
    const int nc = (L + Q - 1) / Q;
    const int q = min(Q, L - c * Q);
    const int64_t tok0 = (int64_t)b * L + (int64_t)c * Q;
    const int slabs = (P + PS - 1) / PS;
    const int units = H * slabs;
    const int mt = warp % MT, wn = warp / MT;       // m-tile; column group of a Q x N product
    const int n0 = wn * (N / WN);                   // its first column
    const bool qwarp = warp < T::QWARPS;            // owns Q x Q tiles: (mt, jt0 ..)
    const int jt0 = wn * QT;
    const int r0 = 16 * mt + gr, r1 = r0 + 8;       // the thread's rows of an m-tile product
    const Lanes ln(lane);
    const int64_t plane = (int64_t)P * N;           // a state's hi (or lo) plane

    // copy unit u (head u / slabs, rows p0 .. p0 + ps of its P) into stage u & 1
    auto issue_unit = [&](int u) {
        const int h = u / slabs, p0 = (u - h * slabs) * PS, ps = min(PS, P - p0);
        unsigned char* st = tc_smem + T::STG + (u & 1) * T::STAGE;
        bf16* Xs = reinterpret_cast<bf16*>(st + T::X_);
        bf16* Ys = reinterpret_cast<bf16*>(st + T::Y_);
        float* dts = reinterpret_cast<float*>(st + T::DT_);
        const int pch = ps / 8;                     // 16-byte chunks of a row of the slab
        for (int i = tid; i < Q * pch; i += kTcThreads) {
            const int r = i / pch, c8 = (i - r * pch) * 8;
            const bool ok = r < q;
            const int64_t g = ((tok0 + (ok ? r : 0)) * H + h) * P + p0 + c8;
            cp_async16(smem_addr(Xs + r * LDS + c8), x + g, ok);
            cp_async16(smem_addr(Ys + r * LDS + c8), dy + g, ok);
        }
        const int64_t so = (((int64_t)b * nc + c) * H + h) * plane * 2 + (int64_t)p0 * N;
        constexpr int NCH = N / 8;
        for (int i = tid; i < ps * NCH; i += kTcThreads) {
            const int r = i / NCH, c8 = (i - r * NCH) * 8;
            const int64_t g = so + (int64_t)r * N + c8;
            const int s = r * LDN + c8;
            cp_async16(smem_addr(reinterpret_cast<bf16*>(st + T::HHI) + s), hs + g, true);
            cp_async16(smem_addr(reinterpret_cast<bf16*>(st + T::HLO) + s), hs + plane + g, true);
            cp_async16(smem_addr(reinterpret_cast<bf16*>(st + T::DHI) + s), dhs + g, true);
            cp_async16(smem_addr(reinterpret_cast<bf16*>(st + T::DLO) + s), dhs + plane + g, true);
        }
        for (int r = tid; r < Q; r += kTcThreads) {
            const bool ok = r < q;
            cp_async4(smem_addr(dts + r), dt + (tok0 + (ok ? r : 0)) * H + h, ok);
        }
    };

    // the chunk's C and B (rows past L zero), with the first unit
    {
        constexpr int NCH = N / 8;
        for (int i = tid; i < Q * NCH; i += kTcThreads) {
            const int r = i / NCH, c8 = (i - r * NCH) * 8;
            const bool ok = r < q;
            const int64_t g = (tok0 + (ok ? r : 0)) * N + c8;
            cp_async16(smem_addr(Cs + r * LDN + c8), Cm + g, ok);
            cp_async16(smem_addr(Bs + r * LDN + c8), Bm + g, ok);
        }
    }
    issue_unit(0);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();

    // G = C . B^T on the warp's Q x Q tiles, once per chunk (exact bf16
    // operands); tiles above the diagonal stay 0
    float G[2 * QT][4];
#pragma unroll
    for (int j = 0; j < 2 * QT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) G[j][e] = 0.f;
    if (qwarp) {
        for (int kk = 0; kk < N / 16; ++kk) {
            uint32_t a[4];
            ldsm_x4(a, smem_addr(Cs + (16 * mt + ln.a_r) * LDN + kk * 16 + ln.a_c));
#pragma unroll
            for (int t = 0; t < QT; ++t) {
                if (jt0 + t > mt) continue;
                uint32_t bk[4];
                ldsm_x4(bk, smem_addr(Bs + (16 * (jt0 + t) + ln.nk_r) * LDN + kk * 16 + ln.nk_c));
                mma_bf16(G[2 * t], a, bk[0], bk[1]);
                mma_bf16(G[2 * t + 1], a, bk[2], bk[3]);
            }
        }
    }

    // the chunk's sums over heads, each element always in the same thread:
    // dC and dB (rows i or j, the warp's N / WN columns), sum_h dG
    float dCa[NB][4], dBa[NB][4], SdG[2 * QT][4];
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) dCa[j][e] = dBa[j][e] = 0.f;
#pragma unroll
    for (int j = 0; j < 2 * QT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) SdG[j][e] = 0.f;

    for (int h = 0; h < H; ++h) {
        const float a_h = A[h];
        float dW[2 * QT][4];
#pragma unroll
        for (int j = 0; j < 2 * QT; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) dW[j][e] = 0.f;
        float s_part[2] = {0.f, 0.f}, t_part[2] = {0.f, 0.f}, red_part = 0.f;
        const float* dts = nullptr;
        for (int s = 0; s < slabs; ++s) {
            const int u = h * slabs + s;
            const int p0 = s * PS, ps = min(PS, P - p0);
            cp_async_wait<0>();     // unit u has landed (this thread's copies)
            // past this barrier: unit u is visible to all, every warp is done
            // with unit u - 1 (its stage is free) and with the previous
            // head's scalar pass
            __syncthreads();
            if (u + 1 < units) issue_unit(u + 1);
            cp_async_commit();
            const unsigned char* stg = tc_smem + T::STG + (u & 1) * T::STAGE;
            const bf16* Xs = reinterpret_cast<const bf16*>(stg + T::X_);
            const bf16* Ys = reinterpret_cast<const bf16*>(stg + T::Y_);
            const bf16* Hh = reinterpret_cast<const bf16*>(stg + T::HHI);
            const bf16* Hl = reinterpret_cast<const bf16*>(stg + T::HLO);
            const bf16* Dh = reinterpret_cast<const bf16*>(stg + T::DHI);
            const bf16* Dl = reinterpret_cast<const bf16*>(stg + T::DLO);
            dts = reinterpret_cast<const float*>(stg + T::DT_);

            if (s == 0) {
                // the head's cumsum (the state passes' bits) and factors;
                // padding keeps cums at its last value and its factors at 0
                if (warp == 0) {
                    chunk_cums(dts, a_h, q, cums);
                    __syncwarp();
                    const float last = cums[q - 1];
                    for (int j = lane; j < Q; j += 32) {
                        const bool ok = j < q;
                        if (!ok) cums[j] = last;
                        ecum[j] = ok ? expf(cums[j]) : 0.f;
                        wend[j] = ok ? expf(last - cums[j]) : 0.f;
                    }
                }
                __syncthreads();
                // W = G exp(cums_i - cums_j) dt_j on the warp's tiles, as
                // hi + lo (the mask a select: j > i never exponentiated)
                if (qwarp) {
#pragma unroll
                    for (int t = 0; t < QT; ++t)
#pragma unroll
                        for (int nb = 0; nb < 2; ++nb) {
                            const int j = 16 * (jt0 + t) + 8 * nb + 2 * tq;
                            float w[4];
#pragma unroll
                            for (int e = 0; e < 4; ++e) {
                                const int i = e < 2 ? r0 : r1, jj = j + (e & 1);
                                const float l = jj <= i ? expf(cums[i] - cums[jj]) : 0.f;
                                w[e] = G[2 * t + nb][e] * l * dts[jj];
                            }
                            uint32_t hi, lo;
                            split2(w[0], w[1], hi, lo);
                            *reinterpret_cast<uint32_t*>(Whi + r0 * LDQ + j) = hi;
                            *reinterpret_cast<uint32_t*>(Wlo + r0 * LDQ + j) = lo;
                            split2(w[2], w[3], hi, lo);
                            *reinterpret_cast<uint32_t*>(Whi + r1 * LDQ + j) = hi;
                            *reinterpret_cast<uint32_t*>(Wlo + r1 * LDQ + j) = lo;
                        }
                }
                __syncthreads();
            }

            // dW += dy . x^T over the slab (exact)
            if (qwarp) {
                for (int kk = 0; kk < ps / 16; ++kk) {
                    uint32_t a[4];
                    ldsm_x4(a, smem_addr(Ys + (16 * mt + ln.a_r) * LDS + kk * 16 + ln.a_c));
#pragma unroll
                    for (int t = 0; t < QT; ++t) {
                        if (jt0 + t > mt) continue;
                        uint32_t bk[4];
                        ldsm_x4(bk, smem_addr(Xs + (16 * (jt0 + t) + ln.nk_r) * LDS + kk * 16 +
                                              ln.nk_c));
                        mma_bf16(dW[2 * t], a, bk[0], bk[1]);
                        mma_bf16(dW[2 * t + 1], a, bk[2], bk[3]);
                    }
                }
            }

            // the state terms: v = exp(cums_i) dy_i . h_prev into dC and
            // S_i = C_i . v; v = exp(cums_last - cums_j) x_j . dh into dB
            // (times dt_j) and T_j = B_j . v.  h_prev and dh enter as hi + lo.
            auto state_term = [&](const bf16* As, const bf16* Sh, const bf16* Sl,
                                  const bf16* Vs, const float* f, const float* d,
                                  float (&into)[NB][4], float (&part)[2]) {
                float acc[NB][4];
#pragma unroll
                for (int j = 0; j < NB; ++j)
#pragma unroll
                    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
                for (int kk = 0; kk < ps / 16; ++kk) {
                    uint32_t a[4];
                    ldsm_x4(a, smem_addr(As + (16 * mt + ln.a_r) * LDS + kk * 16 + ln.a_c));
#pragma unroll
                    for (int nb2 = 0; nb2 < NB / 2; ++nb2) {
                        uint32_t bh[4], bl[4];
                        const int oo = (kk * 16 + ln.kn_r) * LDN + n0 + nb2 * 16 + ln.kn_c;
                        ldsm_x4_trans(bh, smem_addr(Sh + oo));
                        ldsm_x4_trans(bl, smem_addr(Sl + oo));
                        mma_bf16(acc[2 * nb2], a, bh[0], bh[1]);
                        mma_bf16(acc[2 * nb2], a, bl[0], bl[1]);
                        mma_bf16(acc[2 * nb2 + 1], a, bh[2], bh[3]);
                        mma_bf16(acc[2 * nb2 + 1], a, bl[2], bl[3]);
                    }
                }
                const float f0 = f[r0], f1 = f[r1];
                const float d0 = d ? d[r0] : 1.f, d1 = d ? d[r1] : 1.f;
#pragma unroll
                for (int nb = 0; nb < NB; ++nb) {
                    const int n = n0 + 8 * nb + 2 * tq;
                    const float2 v0 = __bfloat1622float2(
                        *reinterpret_cast<const __nv_bfloat162*>(Vs + r0 * LDN + n));
                    const float2 v1 = __bfloat1622float2(
                        *reinterpret_cast<const __nv_bfloat162*>(Vs + r1 * LDN + n));
                    const float u0 = acc[nb][0] * f0, u1 = acc[nb][1] * f0;
                    const float u2 = acc[nb][2] * f1, u3 = acc[nb][3] * f1;
                    part[0] += v0.x * u0 + v0.y * u1;
                    part[1] += v1.x * u2 + v1.y * u3;
                    into[nb][0] += d0 * u0;
                    into[nb][1] += d0 * u1;
                    into[nb][2] += d1 * u2;
                    into[nb][3] += d1 * u3;
                }
            };
            state_term(Ys, Hh, Hl, Cs, ecum, nullptr, dCa, s_part);
            state_term(Xs, Dh, Dl, Bs, wend, dts, dBa, t_part);

            // dh . h_prev over the slab, each thread a fixed share
            for (int i = tid; i < ps * (N / 2); i += kTcThreads) {
                const int p = i / (N / 2), n = (i - p * (N / 2)) * 2;
                const int oo = p * LDN + n;
                const float2 hh = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(Hh + oo));
                const float2 hl = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(Hl + oo));
                const float2 gh = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(Dh + oo));
                const float2 gl = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(Dl + oo));
                red_part += (hh.x + hl.x) * (gh.x + gl.x) + (hh.y + hl.y) * (gh.y + gl.y);
            }

            // dx_j = sum_i W_ij dy_i + exp(cums_last - cums_j) dt_j (dh B_j) on
            // the slab's columns, 16 x 16 tiles over the warps; W and dh enter
            // as hi + lo
            for (int t = warp; t < MT * (ps / 16); t += kTcWarps) {
                const int jt = t % MT, pt = t / MT;
                float a1[2][4], a2[2][4];
#pragma unroll
                for (int j = 0; j < 2; ++j)
#pragma unroll
                    for (int e = 0; e < 4; ++e) a1[j][e] = a2[j][e] = 0.f;
                for (int it = jt; it < MT; ++it) {
                    uint32_t wh[4], wl[4], by[4];
                    const int oo = (16 * it + ln.nk_r) * LDQ + 16 * jt + ln.nk_c;
                    ldsm_x4_trans(wh, smem_addr(Whi + oo));
                    ldsm_x4_trans(wl, smem_addr(Wlo + oo));
                    ldsm_x4_trans(by, smem_addr(Ys + (16 * it + ln.kn_r) * LDS + 16 * pt + ln.kn_c));
                    mma_bf16(a1[0], wh, by[0], by[1]);
                    mma_bf16(a1[0], wl, by[0], by[1]);
                    mma_bf16(a1[1], wh, by[2], by[3]);
                    mma_bf16(a1[1], wl, by[2], by[3]);
                }
                for (int kk = 0; kk < N / 16; ++kk) {
                    uint32_t a[4], gh[4], gl[4];
                    ldsm_x4(a, smem_addr(Bs + (16 * jt + ln.a_r) * LDN + kk * 16 + ln.a_c));
                    const int oo = (16 * pt + ln.nk_r) * LDN + kk * 16 + ln.nk_c;
                    ldsm_x4(gh, smem_addr(Dh + oo));
                    ldsm_x4(gl, smem_addr(Dl + oo));
                    mma_bf16(a2[0], a, gh[0], gh[1]);
                    mma_bf16(a2[0], a, gl[0], gl[1]);
                    mma_bf16(a2[1], a, gh[2], gh[3]);
                    mma_bf16(a2[1], a, gl[2], gl[3]);
                }
                const int j0 = 16 * jt + gr, j1 = j0 + 8;
                const float f0 = wend[j0] * dts[j0], f1 = wend[j1] * dts[j1];
#pragma unroll
                for (int nb = 0; nb < 2; ++nb) {
                    const int p = p0 + 16 * pt + 8 * nb + 2 * tq;
                    if (j0 < q)
                        *reinterpret_cast<uint32_t*>(dx + ((tok0 + j0) * H + h) * P + p) =
                            pack_bf16(a1[nb][0] + f0 * a2[nb][0], a1[nb][1] + f0 * a2[nb][1]);
                    if (j1 < q)
                        *reinterpret_cast<uint32_t*>(dx + ((tok0 + j1) * H + h) * P + p) =
                            pack_bf16(a1[nb][2] + f1 * a2[nb][2], a1[nb][3] + f1 * a2[nb][3]);
                }
            }
        }

        // the head's Q x Q terms on the warp's tiles: dG = dW exp(..) dt_j
        // into sum_h dG; E = dW G exp(..) into rowR (times dt_j) and colE
        if (qwarp) {
            float rr[2] = {0.f, 0.f};
#pragma unroll
            for (int t = 0; t < QT; ++t)
#pragma unroll
                for (int nb = 0; nb < 2; ++nb) {
                    const int j = 16 * (jt0 + t) + 8 * nb + 2 * tq;
                    float ce[2] = {0.f, 0.f};
#pragma unroll
                    for (int e = 0; e < 4; ++e) {
                        const int i = e < 2 ? r0 : r1, jj = j + (e & 1);
                        const float l = jj <= i ? expf(cums[i] - cums[jj]) : 0.f;
                        const float w = dW[2 * t + nb][e], dtj = dts[jj];
                        SdG[2 * t + nb][e] += w * l * dtj;
                        const float ev = w * G[2 * t + nb][e] * l;
                        rr[e >> 1] += ev * dtj;
                        ce[e & 1] += ev;
                    }
                    // the column sums over the warp's 16 rows (lanes of one tq)
#pragma unroll
                    for (int off = 4; off < 32; off <<= 1) {
                        ce[0] += __shfl_xor_sync(0xffffffffu, ce[0], off);
                        ce[1] += __shfl_xor_sync(0xffffffffu, ce[1], off);
                    }
                    if (gr == 0) {
                        colEp[mt * Q + j] = ce[0];
                        colEp[mt * Q + j + 1] = ce[1];
                    }
                }
#pragma unroll
            for (int off = 1; off < 4; off <<= 1) {
                rr[0] += __shfl_xor_sync(0xffffffffu, rr[0], off);
                rr[1] += __shfl_xor_sync(0xffffffffu, rr[1], off);
            }
            if (tq == 0) {
                rowRp[wn * Q + r0] = rr[0];
                rowRp[wn * Q + r1] = rr[1];
            }
        }
#pragma unroll
        for (int off = 1; off < 4; off <<= 1) {
#pragma unroll
            for (int k = 0; k < 2; ++k) {
                s_part[k] += __shfl_xor_sync(0xffffffffu, s_part[k], off);
                t_part[k] += __shfl_xor_sync(0xffffffffu, t_part[k], off);
            }
        }
        if (tq == 0) {
            Sp[wn * Q + r0] = s_part[0];
            Sp[wn * Q + r1] = s_part[1];
            Tp[wn * Q + r0] = t_part[0];
            Tp[wn * Q + r1] = t_part[1];
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
            red_part += __shfl_xor_sync(0xffffffffu, red_part, off);
        if (lane == 0) red[warp] = red_part;
        __syncthreads();

        // warp 0: d(cums) per token (2 a lane), its reversed cumsum d(dt A),
        // then ddt and this chunk's share of dA, every sum in a fixed order
        if (warp == 0) {
            float dh_h = 0.f;
#pragma unroll
            for (int w = 0; w < kTcWarps; ++w) dh_h += red[w];
            float dcum[2], colE[2], Tv[2], dtv[2], dtT = 0.f;
#pragma unroll
            for (int k = 0; k < 2; ++k) {
                const int t = 2 * lane + k;
                float rR = 0.f, cE = 0.f, S = 0.f, Tt = 0.f;
                if (t < q) {
#pragma unroll
                    for (int w = 0; w < T::WQ; ++w) rR += rowRp[w * Q + t];
#pragma unroll
                    for (int m = 0; m < MT; ++m) cE += colEp[m * Q + t];
#pragma unroll
                    for (int w = 0; w < WN; ++w) {
                        S += Sp[w * Q + t];
                        Tt += Tp[w * Q + t];
                    }
                }
                dtv[k] = t < q ? dts[t] : 0.f;
                colE[k] = cE;
                Tv[k] = Tt;
                dcum[k] = rR - cE * dtv[k] + S - dtv[k] * Tt;
                dtT += dtv[k] * Tt;
            }
#pragma unroll
            for (int off = 16; off > 0; off >>= 1) dtT += __shfl_xor_sync(0xffffffffu, dtT, off);
            const int tl = q - 1;                   // the last token takes the chunk's tail
            if (lane == tl >> 1) dcum[tl & 1] += ecum[tl] * dh_h + dtT;
            // da_t = sum of dcum over tokens t .. q - 1
            const float pair = dcum[0] + dcum[1];
            float suf = pair;
#pragma unroll
            for (int off = 1; off < 32; off <<= 1) {
                const float v = __shfl_down_sync(0xffffffffu, suf, off);
                if (lane + off < 32) suf += v;
            }
            float after = __shfl_down_sync(0xffffffffu, suf, 1);
            if (lane == 31) after = 0.f;
            const float da1 = after + dcum[1], da0 = da1 + dcum[0];
            float sum_a = 0.f;
            const float da[2] = {da0, da1};
#pragma unroll
            for (int k = 0; k < 2; ++k) {
                const int t = 2 * lane + k;
                if (t < q) ddt[(tok0 + t) * H + h] = colE[k] + Tv[k] + a_h * da[k];
                sum_a += dtv[k] * da[k];
            }
#pragma unroll
            for (int off = 16; off > 0; off >>= 1) sum_a += __shfl_xor_sync(0xffffffffu, sum_a, off);
            if (lane == 0) pA[((int64_t)b * nc + c) * H + h] = sum_a;
        }
    }

    // sum_h dG as hi + lo into the W tiles (free past this barrier), then the
    // intra-chunk terms once: dC += (sum dG) . B, dB += (sum dG)^T . C
    __syncthreads();
    if (qwarp) {
#pragma unroll
        for (int t = 0; t < QT; ++t)
#pragma unroll
            for (int nb = 0; nb < 2; ++nb) {
                const int j = 16 * (jt0 + t) + 8 * nb + 2 * tq;
                uint32_t hi, lo;
                split2(SdG[2 * t + nb][0], SdG[2 * t + nb][1], hi, lo);
                *reinterpret_cast<uint32_t*>(Whi + r0 * LDQ + j) = hi;
                *reinterpret_cast<uint32_t*>(Wlo + r0 * LDQ + j) = lo;
                split2(SdG[2 * t + nb][2], SdG[2 * t + nb][3], hi, lo);
                *reinterpret_cast<uint32_t*>(Whi + r1 * LDQ + j) = hi;
                *reinterpret_cast<uint32_t*>(Wlo + r1 * LDQ + j) = lo;
            }
    }
    __syncthreads();
    for (int kt = 0; kt <= mt; ++kt) {              // dC rows i: keys j <= i
        uint32_t ah[4], al[4];
        const int oo = (16 * mt + ln.a_r) * LDQ + 16 * kt + ln.a_c;
        ldsm_x4(ah, smem_addr(Whi + oo));
        ldsm_x4(al, smem_addr(Wlo + oo));
#pragma unroll
        for (int nb2 = 0; nb2 < NB / 2; ++nb2) {
            uint32_t bb[4];
            ldsm_x4_trans(bb, smem_addr(Bs + (16 * kt + ln.kn_r) * LDN + n0 + nb2 * 16 + ln.kn_c));
            mma_bf16(dCa[2 * nb2], ah, bb[0], bb[1]);
            mma_bf16(dCa[2 * nb2], al, bb[0], bb[1]);
            mma_bf16(dCa[2 * nb2 + 1], ah, bb[2], bb[3]);
            mma_bf16(dCa[2 * nb2 + 1], al, bb[2], bb[3]);
        }
    }
    for (int kt = mt; kt < MT; ++kt) {              // dB rows j: queries i >= j
        uint32_t ah[4], al[4];
        const int oo = (16 * kt + ln.nk_r) * LDQ + 16 * mt + ln.nk_c;
        ldsm_x4_trans(ah, smem_addr(Whi + oo));
        ldsm_x4_trans(al, smem_addr(Wlo + oo));
#pragma unroll
        for (int nb2 = 0; nb2 < NB / 2; ++nb2) {
            uint32_t bb[4];
            ldsm_x4_trans(bb, smem_addr(Cs + (16 * kt + ln.kn_r) * LDN + n0 + nb2 * 16 + ln.kn_c));
            mma_bf16(dBa[2 * nb2], ah, bb[0], bb[1]);
            mma_bf16(dBa[2 * nb2], al, bb[0], bb[1]);
            mma_bf16(dBa[2 * nb2 + 1], ah, bb[2], bb[3]);
            mma_bf16(dBa[2 * nb2 + 1], al, bb[2], bb[3]);
        }
    }
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
        const int n = n0 + 8 * nb + 2 * tq;
        if (r0 < q) {
            *reinterpret_cast<uint32_t*>(dC + (tok0 + r0) * N + n) = pack_bf16(dCa[nb][0], dCa[nb][1]);
            *reinterpret_cast<uint32_t*>(dB + (tok0 + r0) * N + n) = pack_bf16(dBa[nb][0], dBa[nb][1]);
        }
        if (r1 < q) {
            *reinterpret_cast<uint32_t*>(dC + (tok0 + r1) * N + n) = pack_bf16(dCa[nb][2], dCa[nb][3]);
            *reinterpret_cast<uint32_t*>(dB + (tok0 + r1) * N + n) = pack_bf16(dBa[nb][2], dBa[nb][3]);
        }
    }
}

// The pass rows: 32 state rows a block where P allows, 16 otherwise.
inline int pass_rows(int P) { return P % 32 == 0 ? 32 : 16; }

template <int N, int PT>
cudaError_t tc_passes(const bf16* x, const float* dt, const float* A, const bf16* Bm,
                      const bf16* Cm, const float* h0, const bf16* dy, const float* dh_final,
                      bf16* hs, bf16* dhs, float* dh0, int B, int L, int H, int P,
                      cudaStream_t stream) {
    constexpr int smem = PassTile<N, PT>::BYTES;
    const cudaError_t e = opt_in(tc_state_pass_kernel<N, PT>, smem);
    if (e != cudaSuccess) return e;
    tc_state_pass_kernel<N, PT><<<dim3(H * (P / PT), B, 2), kPassThreads, smem, stream>>>(
        x, dt, A, Bm, Cm, h0, dy, dh_final, hs, dhs, dh0, L, H, P);
    return cudaGetLastError();
}

template <int N>
cudaError_t tc_launch_n(const void* x, const float* dt, const float* A, const void* Bm,
                        const void* Cm, const float* h0, const void* dy, const float* dh_final,
                        void* dx, float* ddt, float* dA, void* dB, void* dC, float* dh0,
                        float* hs, float* dhs, float* pA, int B, int L, int H, int P,
                        cudaStream_t stream) {
    using T = BwdTile<N>;
    const int nc = (L + T::Q - 1) / T::Q;
    const bf16* xb = static_cast<const bf16*>(x);
    const bf16* bb = static_cast<const bf16*>(Bm);
    const bf16* cb = static_cast<const bf16*>(Cm);
    const bf16* dyb = static_cast<const bf16*>(dy);
    bf16* hsb = reinterpret_cast<bf16*>(hs);
    bf16* dhsb = reinterpret_cast<bf16*>(dhs);
    cudaError_t e =
        pass_rows(P) == 32
            ? tc_passes<N, 32>(xb, dt, A, bb, cb, h0, dyb, dh_final, hsb, dhsb, dh0, B, L, H, P,
                               stream)
            : tc_passes<N, 16>(xb, dt, A, bb, cb, h0, dyb, dh_final, hsb, dhsb, dh0, B, L, H, P,
                               stream);
    if (e != cudaSuccess) return e;
    if ((e = opt_in(tc_chunk_kernel<N>, T::BYTES)) != cudaSuccess) return e;
    tc_chunk_kernel<N><<<dim3(nc, B), kTcThreads, T::BYTES, stream>>>(
        xb, dt, A, bb, cb, dyb, hsb, dhsb, static_cast<bf16*>(dx), ddt, pA,
        static_cast<bf16*>(dB), static_cast<bf16*>(dC), L, H, P);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
    // dA: pA summed over batch rows and chunks in order (no row of dB, dC)
    reduce_kernel<bf16><<<(H + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
        pA, nullptr, nullptr, dA, nullptr, nullptr, 0, H, N, B * nc);
    return cudaGetLastError();
}

cudaError_t tc_launch(const void* x, const float* dt, const float* A, const void* Bm,
                      const void* Cm, const float* h0, const void* dy, const float* dh_final,
                      void* dx, float* ddt, float* dA, void* dB, void* dC, float* dh0, float* hs,
                      float* dhs, float* pA, int B, int L, int H, int P, int N,
                      cudaStream_t stream) {
    switch (N) {
        case 64:
            return tc_launch_n<64>(x, dt, A, Bm, Cm, h0, dy, dh_final, dx, ddt, dA, dB, dC, dh0,
                                   hs, dhs, pA, B, L, H, P, stream);
        case 128:
            return tc_launch_n<128>(x, dt, A, Bm, Cm, h0, dy, dh_final, dx, ddt, dA, dB, dC, dh0,
                                    hs, dhs, pA, B, L, H, P, stream);
        case 256:
            return tc_launch_n<256>(x, dt, A, Bm, Cm, h0, dy, dh_final, dx, ddt, dA, dB, dC, dh0,
                                    hs, dhs, pA, B, L, H, P, stream);
        default: return cudaErrorInvalidValue;
    }
}

// The plan of the tensor-core route at these dims (kernels/ssd_scan/plan.py
// models it): chunk, P slab, pass rows, chunk grid (3), threads, shared
// bytes, pass grid (3), threads, shared bytes, head order (0: ascending).
template <int N>
void tc_plan_n(int B, int L, int H, int P, int* out) {
    using T = BwdTile<N>;
    const int PT = pass_rows(P);
    const int v[14] = {T::Q, T::PS, PT, (L + T::Q - 1) / T::Q, B, 1, kTcThreads, T::BYTES,
                       H * (P / PT), B, 2, kPassThreads,
                       PT == 32 ? PassTile<N, 32>::BYTES : PassTile<N, 16>::BYTES, 0};
    for (int i = 0; i < 14; ++i) out[i] = v[i];
}

int tc_chunk(int N) {
    return N == 64 ? BwdTile<64>::Q : N == 128 ? BwdTile<128>::Q : BwdTile<256>::Q;
}

}  // namespace bwd

// 1 = tensor cores, 0 = CUDA cores: the route's rule, from dtype and dims alone
int route_of(int dtype, int P, int N) {
    return dtype == 1 && P % 16 == 0 && (N == 64 || N == 128 || N == 256) ? 1 : 0;
}

}  // namespace

extern "C" {

// The route a call of this dtype, P and N takes (1 = tensor cores, 0 =
// CUDA cores); the wrapper's route() asks this, so the rule lives here only.
int ssd_scan_route(int dtype, int P, int N) { return route_of(dtype, P, N); }

// dtype: 0 = float32, 1 = bfloat16 (x, Bm, Cm and y share it).  h0 may be
// null.  The tensor-core route copies x, Bm and Cm by 16 bytes and h0 and
// h_final by 8 (16 at L = 1): their data must be 16-byte aligned.  Returns a
// cudaError_t: 0 on success, cudaErrorInvalidValue for a dtype, shape or
// alignment the kernel does not take (on the CUDA-core route: shared memory
// too small for even a one-token chunk of this P and N).
int ssd_scan_launch(int dtype, const void* x, const void* dt, const void* A, const void* Bm,
                    const void* Cm, const void* h0, void* y, void* hout, int B, int L, int H,
                    int P, int N, void* stream) {
    if (B < 1 || L < 1 || H < 1 || P < 1 || N < 1 || B > 65535) return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const float* dtf = static_cast<const float*>(dt);
    const float* Af = static_cast<const float*>(A);
    const float* h0f = static_cast<const float*>(h0);
    float* houtf = static_cast<float*>(hout);
    if (route_of(dtype, P, N)) {
        const uintptr_t bits = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(Bm) |
                               reinterpret_cast<uintptr_t>(Cm) | reinterpret_cast<uintptr_t>(h0) |
                               reinterpret_cast<uintptr_t>(hout);
        if ((bits & 15) != 0 || H > 65535) return (int)cudaErrorInvalidValue;
        return (int)tc::launch(x, dtf, Af, Bm, Cm, h0f, y, houtf, B, L, H, P, N, s);
    }
    if (dtype == 0)
        return (int)cc::launch_typed<float>(x, dtf, Af, Bm, Cm, h0f, y, houtf, B, L, H, P, N, s);
    if (dtype == 1)
        return (int)cc::launch_typed<__nv_bfloat16>(x, dtf, Af, Bm, Cm, h0f, y, houtf, B, L, H,
                                                    P, N, s);
    return (int)cudaErrorInvalidValue;
}

// The backward's chunk length for this dtype, L, P and N, or L below it: on
// the tensor-core route 64 tokens (32 at N = 256); on the CUDA-core route the
// longest power of two up to 64 whose tiles fit shared memory, 0 where even a
// one-token chunk does not fit.  The wrapper sizes the scratch by it.
int ssd_scan_backward_chunk(int dtype, int L, int P, int N) {
    if (L < 1 || P < 1 || N < 1) return 0;
    if (route_of(dtype, P, N)) return bwd::tc_chunk(N) < L ? bwd::tc_chunk(N) : L;
    return bwd::chunk_for(L, P, N);
}

// The backward's route, by the forward's rule (route_of): 1 = tensor cores
// for bfloat16 at P a multiple of 16 and N = 64, 128 or 256, 0 = CUDA cores
// (fp32 arithmetic) otherwise; the wrapper's backward_route() asks this, so
// the rule lives here only.
int ssd_scan_backward_route(int dtype, int P, int N) { return route_of(dtype, P, N); }

// The tensor-core route's plan at these dims, 14 ints into out: chunk
// length, the chunk kernel's P slab, the passes' state rows a block, the
// chunk kernel's grid (x, y, z), threads and shared bytes, the passes' grid
// (x, y, z), threads and shared bytes, and the head order (0: ascending).
// kernels/ssd_scan/plan.py models it.  Returns cudaErrorInvalidValue for
// dims the route does not take.
int ssd_scan_backward_plan(int B, int L, int H, int P, int N, int* out) {
    if (B < 1 || L < 1 || H < 1 || !route_of(1, P, N)) return (int)cudaErrorInvalidValue;
    switch (N) {
        case 64: bwd::tc_plan_n<64>(B, L, H, P, out); break;
        case 128: bwd::tc_plan_n<128>(B, L, H, P, out); break;
        default: bwd::tc_plan_n<256>(B, L, H, P, out); break;
    }
    return 0;
}

// Gradients of ssd_scan_launch's (y, h_final) -> (dx, ddt, dA, dBm, dCm, dh0).
// dtype as ssd_scan_launch (x, Bm, Cm, dy, dx, dBm and dCm share it); dt, A,
// h0, dh_final, ddt, dA and dh0 float32.  h0, dh_final (no gradient on the
// final state) and dh0 may be null.  Scratch, sized by the chunk length Q =
// ssd_scan_backward_chunk(dtype, L, P, N) and nc = ceil(L / Q): hs and dhs
// (B, nc, H, P, N) float32 (on the tensor-core route each (b, chunk, head)
// holds a bf16 hi plane and a lo plane in those bytes), pA (B, nc, H)
// float32, and on the CUDA-core route pB and pC (B, L, H, N) float32 (the
// tensor-core route takes none: they may be null).  Three launches on the
// stream: the state passes, the chunk kernel, the reduction.  The
// tensor-core route reads x, Bm, Cm and dy by 16 bytes and h0 and dh_final
// by 8: their data must be 16-byte aligned.  Returns a cudaError_t
// (cudaErrorInvalidValue for a dtype, shape or alignment it does not take:
// a chunk of this P and N beyond shared memory, B > 65535, more than 65535
// chunks on the CUDA-core route).
int ssd_scan_backward_launch(int dtype, const void* x, const void* dt, const void* A,
                             const void* Bm, const void* Cm, const void* h0, const void* dy,
                             const void* dh_final, void* dx, void* ddt, void* dA, void* dB,
                             void* dC, void* dh0, void* hs, void* dhs, void* pA, void* pB,
                             void* pC, int B, int L, int H, int P, int N, void* stream) {
    if (B < 1 || L < 1 || H < 1 || P < 1 || N < 1 || B > 65535 || H > 65535)
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    auto f = [](const void* p) { return static_cast<const float*>(p); };
    auto m = [](void* p) { return static_cast<float*>(p); };
    if (route_of(dtype, P, N)) {
        const uintptr_t bits = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(Bm) |
                               reinterpret_cast<uintptr_t>(Cm) | reinterpret_cast<uintptr_t>(dy) |
                               reinterpret_cast<uintptr_t>(h0) |
                               reinterpret_cast<uintptr_t>(dh_final) |
                               reinterpret_cast<uintptr_t>(dh0);
        if ((bits & 15) != 0) return (int)cudaErrorInvalidValue;
        return (int)bwd::tc_launch(x, f(dt), f(A), Bm, Cm, f(h0), dy, f(dh_final), dx, m(ddt),
                                   m(dA), dB, dC, m(dh0), m(hs), m(dhs), m(pA), B, L, H, P, N,
                                   s);
    }
    if (dtype == 0)
        return (int)bwd::launch_typed<float>(x, f(dt), f(A), Bm, Cm, f(h0), dy, f(dh_final), dx,
                                             m(ddt), m(dA), dB, dC, m(dh0), m(hs), m(dhs), m(pA),
                                             m(pB), m(pC), B, L, H, P, N, s);
    if (dtype == 1)
        return (int)bwd::launch_typed<__nv_bfloat16>(x, f(dt), f(A), Bm, Cm, f(h0), dy,
                                                     f(dh_final), dx, m(ddt), m(dA), dB, dC,
                                                     m(dh0), m(hs), m(dhs), m(pA), m(pB), m(pC),
                                                     B, L, H, P, N, s);
    return (int)cudaErrorInvalidValue;
}

const char* ssd_scan_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
