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
// All arithmetic is fp32.  Only j <= i ever reaches the exponential, so a
// positive difference is never exponentiated (cums falls to -thousands over
// a chunk, and exp of it underflows to 0, which is right).
//
// Design: one block of 256 threads per (b, head) walks the chunks in order,
// so the state never leaves the block.  The (P, N) fp32 state lives in
// shared memory (32 KB at P = 64, N = 128), as do the chunk's x, B and C
// (staged in fp32), the (q, q) weights and the per-token decay factors.
// The chunk length Q is 64, or less where shared memory would not hold the
// tiles (the host picks it).  Each chunk runs the four contractions of the
// TPU kernel's body one after the other, each through the same register-
// tiled product: a 16 x 16 thread grid, 4 x 4 outputs per thread, strided
// by 16 so that the 16 lanes of a half warp read 16 consecutive words of
// the second operand and the two half warps 2 neighbouring words of the
// first.  Shared-memory leading dimensions are odd where a warp walks down a
// column, so those stores do not conflict either.
//   1. C . B^T, masked and decayed in its epilogue into W^T (q, q);
//   2. W x and C . h_prev in one product over the concatenated depth q + N;
//   3. the decayed B^T x state product, folded into the state in place.
// Decode is the q = 1 case with h0: one launch per layer and step.
//
// Bound on the H100 (3.35 TB/s HBM, 67 TFLOP/s fp32 outside the tensor
// cores): a 256-token prefill chunk of mamba2-1.3b (B=1, H=64, P=64, N=128)
// is operations: about 1 GFLOP against 8.5 MB.  A decode step (B=8, L=1) is
// bytes: 33.6 MB of state read and written.  The kernel stays off that bound
// in three known ways, left for later work: C . B^T is recomputed by each of
// the 64 heads (one group), the products run on the fp32 pipes and not the
// tensor cores, and a B=1 grid is 64 blocks on 132 SMs (no split over
// chunks).  In decode the (1 x P) C . h_prev product runs on 16 threads of
// the block.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kGrid = 16;       // 16 x 16 thread grid over an output tile
constexpr int kReg = 4;         // 4 x 4 outputs per thread, strided by kGrid
constexpr int kMaxQ = 64;       // chunk length cap (the scan is one warp, 2 per lane)
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

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (x, Bm, Cm and y share it).  h0 may be
// null.  Returns a cudaError_t: 0 on success, cudaErrorInvalidValue for a
// dtype or shape the kernel does not take (shared memory too small for even
// a one-token chunk of this P and N).
int ssd_scan_launch(int dtype, const void* x, const void* dt, const void* A, const void* Bm,
                    const void* Cm, const void* h0, void* y, void* hout, int B, int L, int H,
                    int P, int N, void* stream) {
    if (B < 1 || L < 1 || H < 1 || P < 1 || N < 1 || B > 65535) return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const float* dtf = static_cast<const float*>(dt);
    const float* Af = static_cast<const float*>(A);
    const float* h0f = static_cast<const float*>(h0);
    float* houtf = static_cast<float*>(hout);
    if (dtype == 0)
        return (int)launch_typed<float>(x, dtf, Af, Bm, Cm, h0f, y, houtf, B, L, H, P, N, s);
    if (dtype == 1)
        return (int)launch_typed<__nv_bfloat16>(x, dtf, Af, Bm, Cm, h0f, y, houtf, B, L, H, P,
                                                N, s);
    return (int)cudaErrorInvalidValue;
}

const char* ssd_scan_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
