// Grouped expert FFN and fp32 router product of a token-choice MoE layer for
// Hopper (sm_90a), bound through a plain C interface and loaded with ctypes
// (repro_torch/kernels/moe_experts/kernel.py).
//
// No Pallas kernel stands behind this one: the JAX package computes its
// experts with einsums over a capacity buffer
// (src/repro/models/moe.py::_dispatch_ffn), every expert over T * k rows
// when routing is drop-free.  Here only the routed (token, expert) pairs
// are computed, sorted by expert:
//
//   x (P, K) bf16, the pairs' rows gathered in expert order; offsets
//   (E + 1,) int32 on the device, expert e's rows [offsets[e],
//   offsets[e + 1]); w1, w2 (E, K, N) bf16 -> out (P, N) bf16.
//
// Modes (one launch each; a SwiGLU layer is a gate/up launch and a down
// launch):
//   0 SwiGLU gate/up  out = bf16(silu(bf16(x.W1)) * bf16(x.W2)), silu's
//                     result rounded to bf16 before the product;
//   1 GELU up         out = bf16(gelu_tanh(bf16(x.W1)));
//   2 plain (down)    out = bf16(x.W1).
// These round where the JAX package's einsums and activations round (each
// einsum's bf16 output, the activation, the product).
//
// A second group rides in the same launch: a segment of `rows` rows with
// one expert of its own width and weights (the shared expert of moonshot,
// 2 x d_expert wide, on the layer's T token rows), so a layer stays two
// launches.
//
// Contract.  Row-invariant and deterministic: an output row depends only
// on its own input row and its expert's weights.  The K loop runs in one
// fixed order (32-wide stages, 16-wide mma steps) whatever the segment's
// length or the row's place in its tile; there is no split-K and no atomic.
// So a token's expert output is bitwise the same in a 1-token decode step
// and in a 256-token chunk.  Fixed-shape: the grid is sized from P, E and
// the second group's rows, never from `offsets`; each block finds its
// (expert, row tile) by walking the offsets on the device and exits when it
// has none, so empty experts cost a walk and nothing else, and a launch is
// capturable in a CUDA graph.
//
// Design (a first version, simple and right): one block of 4 warps per
// (64-row tile within one expert, 128 output columns), the warps 2 x 2,
// each owning 32 rows (two m16 tiles, which share every weight fragment it
// loads) and 64 columns; where the routed segments average 128 rows or
// more (a long prefill) the tile is 128 rows, 8 warps 4 x 2, so each weight
// tile is read once for twice the rows.  bf16 mma.sync.m16n8k16 with fp32
// accumulation; the x tile and the weight tiles (two for SwiGLU, which
// share the x tile) arrive by 16-byte cp.async in a 3-stage ring, rows
// padded by 16 bytes so ldmatrix meets no bank conflict (SwiGLU 66 KiB at
// 64 rows, 81 KiB at 128; down 41 and 56 KiB).  A
// warp skips the products of an m16 tile whose rows all lie past its
// segment's end (a decode segment of 1-2 rows keeps one m16 tile of two
// warps busy).  The tile shape changes no row's sums: every output is the
// same chain of k16 products from k = 0, whatever tile holds its row.
//
// Bound on the H100 (3.35 TB/s HBM; 989 TFLOP/s dense bf16): moonshot's
// experts (D = 2048, F = 1408) hold 17.3 MB of bf16 weights each.  A
// decode step of 8 slots (48 pairs, ~34 experts hit) must read those
// experts' weights once: ~0.18 ms per layer, bound by bytes.  A 256-token
// chunk (1536 pairs, all 64 experts) reads 1.1 GB for 26.6 GFLOP: ~0.33 ms,
// bytes.  A 4096-token prefill (24576 pairs) does 425 GFLOP: ~0.43 ms,
// operations.  A segment of a few rows fills 1/64 of its tile's products,
// which costs nothing where bytes bound the call.  Levers left: wgmma on
// 64-row warpgroup tiles with B read from shared memory, TMA with
// mbarriers and a producer warp, 128-row tiles for long segments, and an
// expert-tile schedule that walks the weights once across row tiles.
//
// The router product (moe_router_launch) is fp32 on the CUDA cores: logits
// (T, E) = x (T, D) bf16 widened to fp32 times w (D, E) fp32, never TF32.
// Each logit is one fixed-order sum (32 slices of D summed in order, each a
// sequential FMA chain), so it too is row-invariant: a route cannot flip
// between a decode step and a chunk because a library picked another
// summation for another row count.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBN = 128;             // output columns per tile
constexpr int kWM = 32;              // rows per warp: two m16 tiles
constexpr int kWN = 64;              // columns per warp
constexpr int kMT = kWM / 16;
constexpr int kBK = 32;              // K per stage
constexpr int kStages = 3;
constexpr int kLdA = kBK + 8;        // padded row of an x tile (elements)
constexpr int kLdB = kBN + 8;        // padded row of a weight tile
constexpr int kStageB = kBK * kLdB;
// Rows per tile: 64 (4 warps, 2 x 2), or 128 (8 warps, 4 x 2) when the
// routed segments average 128 rows or more (a long prefill), where the
// taller tile reads each weight tile for twice the rows.
constexpr int kBMShort = 64, kBMLong = 128;

template <int BM>
struct Tile {
    static constexpr int kThreads = BM / kWM * (kBN / kWN) * 32;
    static constexpr int kStageA = BM * kLdA;
};

enum Mode { kSwiGLU = 0, kGelu = 1, kPlain = 2 };

struct Group {
    const __nv_bfloat16* x;      // (rows, K)
    const int* offsets;          // (n_exp + 1,) on the device, or null: one segment of `rows`
    const __nv_bfloat16* w1;     // (n_exp, K, N)
    const __nv_bfloat16* w2;     // (n_exp, K, N), SwiGLU only
    __nv_bfloat16* out;          // (rows, N)
    int rows, n_exp, K, N;
    int slots;                   // row-tile slots of the grid
};

__host__ __device__ constexpr int smem_bytes(int mode, int bm) {
    return kStages * (bm * kLdA + (mode == kSwiGLU ? 2 : 1) * kStageB) * 2;
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

__device__ __forceinline__ float round_bf16(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
}

// The activations as PyTorch computes them on bf16 tensors: in fp32 from
// the bf16 value, one rounding of the result.
__device__ __forceinline__ float silu(float x) { return x / (1.f + expf(-x)); }

__device__ __forceinline__ float gelu_tanh(float x) {
    const float kBeta = 0.7978845608028654f;     // sqrt(2 / pi)
    const float kKappa = 0.044715f;
    const float inner = kBeta * (x + kKappa * (x * x * x));
    return 0.5f * x * (1.f + tanhf(inner));
}

// The block's (expert, rows [r0, r1)) for slot s of group g, in tiles of
// BM rows; false when the slot lies past the group's last tile.
template <int BM>
__device__ __forceinline__ bool find_tile(const Group& g, int s, int& e, int& r0, int& r1) {
    if (g.offsets == nullptr) {
        e = 0;
        r0 = s * BM;
        r1 = min(r0 + BM, g.rows);
        return r0 < g.rows;
    }
    int lo = __ldg(g.offsets);
    for (int i = 0; i < g.n_exp; ++i) {
        const int hi = __ldg(g.offsets + i + 1);
        const int n = (hi - lo + BM - 1) / BM;
        if (s < n) {
            e = i;
            r0 = lo + s * BM;
            r1 = min(r0 + BM, hi);
            return true;
        }
        s -= n;
        lo = hi;
    }
    return false;
}

template <int MODE, int BM>
__global__ void __launch_bounds__(Tile<BM>::kThreads)
moe_experts_kernel(Group g0, Group g1) {
    constexpr bool kTwo = MODE == kSwiGLU;
    constexpr int NB = kWN / 8;                 // 8-column blocks a warp accumulates
    constexpr int kThreads = Tile<BM>::kThreads;
    constexpr int kStageA = Tile<BM>::kStageA;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    __nv_bfloat16* sa = reinterpret_cast<__nv_bfloat16*>(smem_raw);
    __nv_bfloat16* sb1 = sa + kStages * kStageA;
    __nv_bfloat16* sb2 = sb1 + kStages * kStageB;

    int s = blockIdx.x;
    const bool first = s < g0.slots;
    const Group& g = first ? g0 : g1;
    if (!first) s -= g0.slots;
    int e, r0, r1;
    if (!find_tile<BM>(g, s, e, r0, r1)) return;
    const int n0 = blockIdx.y * kBN;
    const int K = g.K, N = g.N;
    if (n0 >= N) return;
    const __nv_bfloat16* x = g.x;
    const __nv_bfloat16* w1 = g.w1 + (int64_t)e * K * N;
    const __nv_bfloat16* w2 = kTwo ? g.w2 + (int64_t)e * K * N : nullptr;
    const int nk = (K + kBK - 1) / kBK;

    // one cp.async group per stage: the x tile (rows past the segment's
    // end and columns past K zero-filled) and the weight tiles (rows past
    // K and columns past N zero-filled)
    auto load_stage = [&](int kt, int st) {
        const int k0 = kt * kBK;
        for (int i = threadIdx.x; i < BM * (kBK / 8); i += kThreads) {
            const int row = i / (kBK / 8), c = (i % (kBK / 8)) * 8;
            const int r = r0 + row, k = k0 + c;
            const bool ok = r < r1 && k < K;
            cp_async16(smem_addr(sa + st * kStageA + row * kLdA + c),
                       x + (ok ? (int64_t)r * K + k : 0), ok);
        }
        for (int i = threadIdx.x; i < kBK * (kBN / 8); i += kThreads) {
            const int row = i / (kBN / 8), c = (i % (kBN / 8)) * 8;
            const int k = k0 + row, n = n0 + c;
            const bool ok = k < K && n < N;
            const int64_t off = ok ? (int64_t)k * N + n : 0;
            cp_async16(smem_addr(sb1 + st * kStageB + row * kLdB + c), w1 + off, ok);
            if (kTwo) cp_async16(smem_addr(sb2 + st * kStageB + row * kLdB + c), w2 + off, ok);
        }
    };

#pragma unroll
    for (int i = 0; i < kStages - 1; ++i) {
        if (i < nk) load_stage(i, i);
        cp_async_commit();
    }

    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int wr = warp >> 1, wc = warp & 1;
    const int row_w = r0 + kWM * wr, col_w = n0 + kWN * wc;    // the warp's first row, column
    const bool live = row_w < r1 && col_w < N;
    const bool live1 = row_w + 16 < r1;                       // its second m16 tile
    float acc1[kMT][NB][4], acc2[kMT][NB][4];
#pragma unroll
    for (int m = 0; m < kMT; ++m)
#pragma unroll
        for (int j = 0; j < NB; ++j)
#pragma unroll
            for (int c = 0; c < 4; ++c) acc1[m][j][c] = acc2[m][j][c] = 0.f;

    // ldmatrix row addresses: A (x) rows lane & 15, k half lane >> 4; B (W,
    // K x N row-major, read by .trans) k rows (lane & 7) + 8 ((lane >> 3) & 1),
    // column half lane >> 4
    const int a_off = (kWM * wr + (lane & 15)) * kLdA + ((lane >> 4) << 3);
    const int b_off = ((lane & 7) + (((lane >> 3) & 1) << 3)) * kLdB + kWN * wc +
                      ((lane >> 4) << 3);

    for (int kt = 0; kt < nk; ++kt) {
        const int st = kt % kStages;
        cp_async_wait<kStages - 2>();       // stage kt has landed
        // one barrier a stage: past it every warp is done with stage kt - 1,
        // which the copy of stage kt + kStages - 1 now refills
        __syncthreads();
        if (kt + kStages - 1 < nk) load_stage(kt + kStages - 1, (kt + kStages - 1) % kStages);
        cp_async_commit();
        if (!live) continue;
        const uint32_t a_base = smem_addr(sa + st * kStageA + a_off);
        const uint32_t b1_base = smem_addr(sb1 + st * kStageB + b_off);
        const uint32_t b2_base = smem_addr(sb2 + st * kStageB + b_off);
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk) {
            uint32_t a[kMT][4];
            ldsm_x4(a[0], a_base + kk * 16 * 2);
            if (live1) ldsm_x4(a[1], a_base + (16 * kLdA + kk * 16) * 2);
#pragma unroll
            for (int nb = 0; nb < kWN / 16; ++nb) {
                const uint32_t off = (kk * 16 * kLdB + nb * 16) * 2;
                uint32_t b[4];
                ldsm_x4_trans(b, b1_base + off);
                mma_bf16(acc1[0][2 * nb], a[0], b[0], b[1]);
                mma_bf16(acc1[0][2 * nb + 1], a[0], b[2], b[3]);
                if (live1) {
                    mma_bf16(acc1[1][2 * nb], a[1], b[0], b[1]);
                    mma_bf16(acc1[1][2 * nb + 1], a[1], b[2], b[3]);
                }
                if (kTwo) {
                    ldsm_x4_trans(b, b2_base + off);
                    mma_bf16(acc2[0][2 * nb], a[0], b[0], b[1]);
                    mma_bf16(acc2[0][2 * nb + 1], a[0], b[2], b[3]);
                    if (live1) {
                        mma_bf16(acc2[1][2 * nb], a[1], b[0], b[1]);
                        mma_bf16(acc2[1][2 * nb + 1], a[1], b[2], b[3]);
                    }
                }
            }
        }
    }
    cp_async_wait<0>();
    if (!live) return;

    // fragment layout of m16n8k16 (lane = 4 gr + tq): c[0..1] row gr,
    // columns 2 tq and 2 tq + 1; c[2..3] the same columns of row gr + 8
    const int gr = lane >> 2, tq = lane & 3;
#pragma unroll
    for (int m = 0; m < kMT; ++m) {
#pragma unroll
        for (int j = 0; j < NB; ++j) {
            const int c = col_w + 8 * j + 2 * tq;
            if (c >= N) continue;                    // N % 8 == 0: c + 1 < N too
#pragma unroll
            for (int half = 0; half < 2; ++half) {
                const int row = row_w + 16 * m + gr + 8 * half;
                if (row >= r1) continue;
                float v[2];
#pragma unroll
                for (int i = 0; i < 2; ++i) {
                    const float a = round_bf16(acc1[m][j][2 * half + i]);
                    if (MODE == kSwiGLU) {
                        const float u = round_bf16(acc2[m][j][2 * half + i]);
                        v[i] = round_bf16(silu(a)) * u;
                    } else if (MODE == kGelu) {
                        v[i] = gelu_tanh(a);
                    } else {
                        v[i] = a;
                    }
                }
                __nv_bfloat162 pair = __floats2bfloat162_rn(v[0], v[1]);
                *reinterpret_cast<__nv_bfloat162*>(g.out + (int64_t)row * N + c) = pair;
            }
        }
    }
}

// Row-tile slots of the grid: group 0's tiles number at most rows / BM +
// n_exp (each expert adds at most one partial tile), group 1's ceil(rows /
// BM); both from shapes alone.
template <int MODE, int BM>
cudaError_t launch_tiles(Group g0, Group g1, cudaStream_t stream) {
    const int64_t slots0 = (int64_t)g0.rows / BM + g0.n_exp;
    const int64_t slots1 = ((int64_t)g1.rows + BM - 1) / BM;
    if (slots0 + slots1 > 0x7fffffff) return cudaErrorInvalidValue;
    g0.slots = (int)slots0;
    g1.slots = (int)slots1;
    const int smem = smem_bytes(MODE, BM);
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(moe_experts_kernel<MODE, BM>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (e != cudaSuccess) return e;
    }
    const int n_max = max(g0.N, g1.rows > 0 ? g1.N : 0);
    const dim3 grid(g0.slots + g1.slots, (n_max + kBN - 1) / kBN);
    moe_experts_kernel<MODE, BM><<<grid, Tile<BM>::kThreads, smem, stream>>>(g0, g1);
    return cudaGetLastError();
}

template <int MODE>
cudaError_t launch_mode(const Group& g0, const Group& g1, cudaStream_t stream) {
    if ((int64_t)g0.rows >= (int64_t)kBMLong * g0.n_exp)
        return launch_tiles<MODE, kBMLong>(g0, g1, stream);
    return launch_tiles<MODE, kBMShort>(g0, g1, stream);
}

// -- router -------------------------------------------------------------------------

constexpr int kRouterSlices = 32;    // warps a block: slices of D, summed in order
constexpr int kRouterTokens = 8;     // tokens a thread accumulates

// One block per (8 tokens, 32 experts): lane = expert, warp = one of 32
// slices of D (its length even, fixed by D alone).  A thread walks its
// slice two d at a time (a bf16 pair of each token's row, two weights),
// one FMA chain per token in d order; warp 0 then adds the 32 slice sums
// in order.  So every logit is one sum whose order depends on D alone.
__global__ void __launch_bounds__(32 * kRouterSlices)
moe_router_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ w,
                  float* __restrict__ out, int T, int D, int E) {
    __shared__ float part[kRouterSlices][kRouterTokens][32];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int e = blockIdx.y * 32 + lane;
    const int t0 = blockIdx.x * kRouterTokens;
    const int slice = (((D + kRouterSlices - 1) / kRouterSlices) + 1) & ~1;
    const int d0 = min(D, warp * slice), d1 = min(D, d0 + slice);
    const float* wc = w + min(e, E - 1);
    const __nv_bfloat16* xr[kRouterTokens];
#pragma unroll
    for (int r = 0; r < kRouterTokens; ++r) xr[r] = x + (int64_t)min(t0 + r, T - 1) * D;
    float acc[kRouterTokens];
#pragma unroll
    for (int r = 0; r < kRouterTokens; ++r) acc[r] = 0.f;
#pragma unroll 4
    for (int d = d0; d < d1; d += 2) {            // D even: d + 1 < d1
        const float w0 = __ldg(wc + (int64_t)d * E), w1 = __ldg(wc + (int64_t)(d + 1) * E);
#pragma unroll
        for (int r = 0; r < kRouterTokens; ++r) {
            const float2 xv = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(xr[r] + d));
            acc[r] = fmaf(xv.x, w0, acc[r]);
            acc[r] = fmaf(xv.y, w1, acc[r]);
        }
    }
#pragma unroll
    for (int r = 0; r < kRouterTokens; ++r) part[warp][r][lane] = acc[r];
    __syncthreads();
    if (warp == 0 && e < E) {
        for (int r = 0; r < kRouterTokens && t0 + r < T; ++r) {
            float sum = part[0][r][lane];
#pragma unroll
            for (int k = 1; k < kRouterSlices; ++k) sum += part[k][r][lane];
            out[(int64_t)(t0 + r) * E + e] = sum;
        }
    }
}

}  // namespace

extern "C" {

// mode: 0 SwiGLU gate/up (w1 gate, w2 up), 1 GELU up (w1), 2 plain (w1).
// Group 0 is the routed pairs: x0 (rows0, K0), offsets0 (n_exp0 + 1,) int32
// on the device, w1_0 / w2_0 (n_exp0, K0, N0), out0 (rows0, N0).  Group 1,
// when rows1 > 0, is one expert over rows1 rows: x1 (rows1, K1), w1_1 /
// w2_1 (K1, N1), out1 (rows1, N1).  All bf16, contiguous, 16-byte aligned;
// K and N multiples of 8.  Returns a cudaError_t: 0 on success,
// cudaErrorInvalidValue for a mode or shape the kernel does not take.
int moe_experts_launch(int mode, const void* x0, const void* offsets0, int rows0, int n_exp0,
                       const void* w1_0, const void* w2_0, void* out0, int K0, int N0,
                       const void* x1, int rows1, const void* w1_1, const void* w2_1,
                       void* out1, int K1, int N1, void* stream) {
    if (mode < 0 || mode > 2 || rows0 < 0 || n_exp0 < 1 || rows1 < 0 || K0 < 8 ||
        K0 % 8 || N0 < 8 || N0 % 8 || offsets0 == nullptr)
        return (int)cudaErrorInvalidValue;
    if (rows1 > 0 && (K1 < 8 || K1 % 8 || N1 < 8 || N1 % 8))
        return (int)cudaErrorInvalidValue;
    if ((int64_t)max(N0, N1) / kBN > 65535) return (int)cudaErrorInvalidValue;
    Group g0{static_cast<const __nv_bfloat16*>(x0), static_cast<const int*>(offsets0),
             static_cast<const __nv_bfloat16*>(w1_0), static_cast<const __nv_bfloat16*>(w2_0),
             static_cast<__nv_bfloat16*>(out0), rows0, n_exp0, K0, N0, 0};
    Group g1{static_cast<const __nv_bfloat16*>(x1), nullptr,
             static_cast<const __nv_bfloat16*>(w1_1), static_cast<const __nv_bfloat16*>(w2_1),
             static_cast<__nv_bfloat16*>(out1), rows1, 1, K1, N1, 0};
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (mode) {
        case kSwiGLU: return (int)launch_mode<kSwiGLU>(g0, g1, s);
        case kGelu: return (int)launch_mode<kGelu>(g0, g1, s);
        default: return (int)launch_mode<kPlain>(g0, g1, s);
    }
}

// logits (T, E) fp32 = x (T, D) bf16 . w (D, E) fp32, contiguous; D even
// (x 4-byte aligned).
int moe_router_launch(const void* x, const void* w, void* out, int T, int D, int E,
                      void* stream) {
    if (T < 1 || D < 2 || D % 2 || E < 1 || (reinterpret_cast<uintptr_t>(x) & 3))
        return (int)cudaErrorInvalidValue;
    const int64_t gx = ((int64_t)T + kRouterTokens - 1) / kRouterTokens;
    const int gy = (E + 31) / 32;
    if (gx > 0x7fffffff || gy > 65535) return (int)cudaErrorInvalidValue;
    moe_router_kernel<<<dim3((unsigned)gx, gy), 32 * kRouterSlices, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(w),
        static_cast<float*>(out), T, D, E);
    return (int)cudaGetLastError();
}

const char* moe_experts_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
