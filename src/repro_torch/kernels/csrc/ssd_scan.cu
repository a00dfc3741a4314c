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

const char* ssd_scan_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
