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
// on its own input row and its expert's weights.  Every row, whatever its
// segment's length or its place in a tile, is the same chain of bf16
// wgmma.m64n128k16 steps from k = 0 into fp32 registers, K zero-padded to
// a multiple of 64 the same way for all; there is no split-K and no atomic.
// So a token's expert output is bitwise the same in a 1-token decode step
// and in a 4096-token prefill.  Fixed-shape: the grid is sized from P, E,
// the widths and the SM count, never from `offsets`, so a launch is
// capturable in a CUDA graph; the tensor maps pass by value and hold the
// addresses of the call that was captured.
//
// Design for the H100.  A persistent grid (one block an SM) walks a static
// list of work items, each (expert, row tile of BM rows, 128 output
// columns): expert by expert, and within an expert column tile by column
// tile with the row tiles innermost, so the blocks running at one time
// share each weight tile while it is in L2.  Item i goes to block i mod
// grid; every block derives the list from the device-side offsets (a warp
// scan of the experts' tile counts) and its item's (expert, rows) by
// walking that prefix forward.  A block is one producer warpgroup, whose
// one thread keeps a ring in flight with TMA, and one consumer warpgroup
// per 64 rows issuing wgmma with both operands in shared memory (x
// K-major; the weights, (E, K, N) row-major, N-major through the
// transpose bit).  A stage is the x tile (BM rows x 64 k) and the 64 x 128
// tile of each weight matrix, 128-byte swizzled, zero outside the
// tensors; the ring holds as many stages as 227 KB allows, at most 8, and
// 4 on 128-row tiles, which are bound by operations.  SwiGLU's gate and up
// accumulators share each x tile.  Where the routed segments average 128
// rows or more (a long prefill) BM is 128 and two consumer warpgroups
// (setmaxnreg: 232 registers each, the producer 40) share every weight
// tile; otherwise BM is 64.  Rows of a tile past its segment's end are
// loaded and multiplied (they belong to the next expert, or read as zero
// past P) but never stored.  The epilogue (bf16 roundings, SiLU or GELU,
// the product) runs in registers and stores bf16 pairs while the producer
// already streams the next item's tiles.
//
// Bound on the H100 (3.35 TB/s HBM; 989 TFLOP/s dense bf16): moonshot's
// experts (D = 2048, F = 1408) hold 17.3 MB of bf16 weights each.  A
// decode step of 8 slots (48 pairs, ~36 experts hit) must read those
// experts' weights once: ~0.20 ms per layer, bound by bytes; its items
// are 418 gate/up and 592 down over 132 SMs, and a ring of 192-200 KB
// lets the blocks that hold one item more draw more than their share.  A
// 256-token chunk (1536 pairs, all 64 experts) reads 1.17 GB for 26.6
// GFLOP: ~0.35 ms, bytes.  A 4096-token prefill (24576 pairs) does 567
// GFLOP: ~0.57 ms, operations.  A decode segment of 1-2 rows fills 1/64 of
// its tile's products (~27 GFLOP a layer, ~0.03 ms), which costs nothing
// while bytes stay in flight.

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
#include <string.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kBN = 128;             // output columns per item
constexpr int kBK = 64;              // K per stage: one 128-byte swizzle row
constexpr int kWgRows = 64;          // rows per consumer warpgroup (one wgmma)
constexpr int kMaxStages = 8;
constexpr int kTallStages = 4;       // 128-row tiles are bound by operations: a shallower ring
constexpr int kSmemLimit = 227 * 1024;
constexpr int kWTile = kBK * kBN * 2;                // one weight matrix's stage: 16 KiB
constexpr int kWBox = kBK * 64 * 2;                  // one TMA box of it: 64 k x 64 n

enum Mode { kSwiGLU = 0, kGelu = 1, kPlain = 2 };

struct GroupArgs {
    __nv_bfloat16* out;          // (rows, N)
    const int* offsets;          // (n_exp + 1,) on the device, or null: one segment of `rows`
    int rows, n_exp, K, N;
};

struct Params {
    CUtensorMap a0, w1_0, w2_0;  // group 0: x (K, rows) box (64, BM); w (N, K, E) box (64, 64, 1)
    CUtensorMap a1, w1_1, w2_1;  // group 1, the same with E = 1
    GroupArgs g0, g1;
    int stages;
};

__host__ __device__ constexpr int n_mats(int mode) { return mode == kSwiGLU ? 2 : 1; }

__host__ __device__ constexpr int stage_bytes(int mode, int bm) {
    return bm * kBK * 2 + n_mats(mode) * kWTile;
}

// Dynamic shared memory: the ring (1024-byte aligned tiles), its full and
// empty barriers, the clamped offsets and the experts' first items.
__host__ __device__ constexpr int table_bytes(int stages, int n_exp) {
    return stages * 16 + 2 * (n_exp + 1) * 4;
}

__host__ __device__ constexpr int smem_bytes(int mode, int bm, int stages, int n_exp) {
    return 1024 + stages * stage_bytes(mode, bm) + table_bytes(stages, n_exp);
}

__host__ __device__ constexpr int ring_stages(int mode, int bm, int n_exp) {
    const int s = (kSmemLimit - 1024 - table_bytes(kMaxStages, n_exp)) / stage_bytes(mode, bm);
    const int cap = bm > kWgRows ? kTallStages : kMaxStages;
    return s < cap ? s : cap;
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

struct Item {
    int group, e, r0, r1, n0;
};

// Work item i: group 0's experts in order, each its column tiles with the
// row tiles innermost, then group 1's the same way.  `offs` are group 0's
// clamped offsets, `first[e]` expert e's first item (first[E] = group 0's
// item count); `cursor` walks the experts forward, as a block's items only
// grow.  kernels/moe_experts/plan.py mirrors this map.
template <int BM>
__device__ __forceinline__ Item item_of(int i, const Params& p, const int* offs,
                                        const int* first, int& cursor) {
    Item it;
    const int n_exp = p.g0.n_exp;
    if (i < first[n_exp]) {
        while (first[cursor + 1] <= i) ++cursor;
        const int lo = offs[cursor], hi = offs[cursor + 1];
        const int rt = (hi - lo + BM - 1) / BM, j = i - first[cursor];
        const int c = j / rt;
        it.group = 0;
        it.e = cursor;
        it.r0 = lo + (j - c * rt) * BM;
        it.r1 = min(it.r0 + BM, hi);
        it.n0 = c * kBN;
    } else {
        const int rt = (p.g1.rows + BM - 1) / BM, j = i - first[n_exp];
        const int c = j / rt;
        it.group = 1;
        it.e = 0;
        it.r0 = (j - c * rt) * BM;
        it.r1 = min(it.r0 + BM, p.g1.rows);
        it.n0 = c * kBN;
    }
    return it;
}

template <int MODE, int NWG>
__global__ void __launch_bounds__(128 * (NWG + 1), 1)
moe_experts_kernel(const __grid_constant__ Params p) {
    constexpr int BM = kWgRows * NWG;
    constexpr int kMats = n_mats(MODE);
    constexpr int kABytes = BM * kBK * 2;
    constexpr int kStage = stage_bytes(MODE, BM);
    extern __shared__ unsigned char smem_raw[];
    // the ring starts on a 1024-byte boundary of the shared window (the swizzle atom)
    unsigned char* ring = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
    const int S = p.stages;
    uint64_t* full = reinterpret_cast<uint64_t*>(ring + S * kStage);
    uint64_t* empty = full + S;
    int* offs = reinterpret_cast<int*>(empty + S);
    const int n_exp = p.g0.n_exp;
    int* first = offs + n_exp + 1;

    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    if (threadIdx.x == 0) {
        for (int s = 0; s < S; ++s) {
            mbar_init(&full[s], 1);
            mbar_init(&empty[s], 4 * NWG);       // lane 0 of every consumer warp
        }
        mbar_fence_init();
    }
    if (warp == 0) {
        // the experts' item counts, scanned: lane l takes a run of experts
        const int nc = (p.g0.N + kBN - 1) / kBN, P = p.g0.rows;
        const int per = (n_exp + 31) / 32;
        const int e0 = min(n_exp, lane * per), e1 = min(n_exp, e0 + per);
        auto clamp = [&](int e) { return min(max(__ldg(p.g0.offsets + e), 0), P); };
        auto items = [&](int lo, int hi) { return max(hi - lo + BM - 1, 0) / BM * nc; };
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
    __syncthreads();

    const int n_items =
        first[n_exp] + (p.g1.rows + BM - 1) / BM * ((p.g1.N + kBN - 1) / kBN);
    const int wg = threadIdx.x >> 7;
    if (wg == NWG) {
        // producer: one thread keeps the ring full across items
        if constexpr (NWG > 1) reg_dealloc<40>();
        if (threadIdx.x != 128 * NWG) return;
        int s = 0, cursor = 0;
        uint32_t phase = 0;
        for (int i = blockIdx.x; i < n_items; i += gridDim.x) {
            const Item it = item_of<BM>(i, p, offs, first, cursor);
            const bool g1 = it.group == 1;
            const CUtensorMap* ma = g1 ? &p.a1 : &p.a0;
            const CUtensorMap* mw1 = g1 ? &p.w1_1 : &p.w1_0;
            const CUtensorMap* mw2 = g1 ? &p.w2_1 : &p.w2_0;
            const int nk = ((g1 ? p.g1.K : p.g0.K) + kBK - 1) / kBK;
            for (int kt = 0; kt < nk; ++kt) {
                mbar_wait(&empty[s], phase ^ 1);
                unsigned char* st = ring + s * kStage;
                mbar_arrive_expect_tx(&full[s], kStage);
                const int k0 = kt * kBK;
                tma_load_2d(st, ma, &full[s], k0, it.r0);
                tma_load_3d(st + kABytes, mw1, &full[s], it.n0, k0, it.e);
                tma_load_3d(st + kABytes + kWBox, mw1, &full[s], it.n0 + 64, k0, it.e);
                if constexpr (kMats == 2) {
                    tma_load_3d(st + kABytes + kWTile, mw2, &full[s], it.n0, k0, it.e);
                    tma_load_3d(st + kABytes + kWTile + kWBox, mw2, &full[s], it.n0 + 64, k0,
                                it.e);
                }
                if (++s == S) {
                    s = 0;
                    phase ^= 1;
                }
            }
        }
    } else {
        // consumer warpgroup wg: rows [64 wg, 64 wg + 64) of each item's
        // tile, multiplied whether or not they lie inside the segment.  No
        // branch but the loops' surrounds a wgmma, and every value that
        // steers one is broadcast from lane 0, so the compiler sees
        // warp-uniform control flow and keeps a stage's wgmmas in flight
        // together (a branch around them serialises them: ptxas C7518).
        if constexpr (NWG > 1) reg_alloc<232>();
        float acc1[64], acc2[64];
        int s = 0, cursor = 0;
        uint32_t phase = 0;
        const int t = threadIdx.x & 127;
        const int cwg = uniform(wg);
        const int items_u = uniform(n_items);
        for (int i = blockIdx.x; i < items_u; i += gridDim.x) {
            const Item it = item_of<BM>(i, p, offs, first, cursor);
            const int group = uniform(it.group), r0 = uniform(it.r0), r1 = uniform(it.r1);
            const GroupArgs& g = group == 1 ? p.g1 : p.g0;
            const int nk = (g.K + kBK - 1) / kBK;
#pragma unroll
            for (int j = 0; j < 64; ++j) acc1[j] = acc2[j] = 0.f;
            for (int kt = 0; kt < nk; ++kt) {
                mbar_wait(&full[s], phase);
                const uint32_t a = smem_u32(ring + s * kStage) + cwg * (kWgRows * kBK * 2);
                const uint32_t b = smem_u32(ring + s * kStage + kABytes);
                fence_operands(acc1);
                if constexpr (kMats == 2) fence_operands(acc2);
                wgmma_fence();
#pragma unroll
                for (int kk = 0; kk < kBK / 16; ++kk) {
                    const uint64_t da = sw128_desc(a + kk * 32, 16, 1024);
                    wgmma_m64n128k16_bf16(acc1, da, sw128_desc(b + kk * 2048, kWBox, 1024));
                    if constexpr (kMats == 2)
                        wgmma_m64n128k16_bf16(acc2, da,
                                              sw128_desc(b + kWTile + kk * 2048, kWBox, 1024));
                }
                wgmma_commit();
                fence_operands(acc1);
                if constexpr (kMats == 2) fence_operands(acc2);
                wgmma_wait<1>();                // stage kt - 1's products are done
                // release stage kt - 1 (lane 0 of each warp)
                mbar_arrive_if(&empty[s == 0 ? S - 1 : s - 1], lane == 0 && kt > 0);
                if (++s == S) {
                    s = 0;
                    phase ^= 1;
                }
            }
            wgmma_wait<0>();
            fence_operands(acc1);
            if constexpr (kMats == 2) fence_operands(acc2);
            mbar_arrive_if(&empty[s == 0 ? S - 1 : s - 1], lane == 0 && nk > 0);

            // epilogue: thread t holds rows 16 (t / 32) + (t % 32) / 4 (+ 8)
            // and columns 8 j + 2 (t % 4) (+ 1) of the warpgroup's 64 x 128;
            // every value is computed, the stores past the segment's end or
            // past N are predicated off
            const int row_a = r0 + kWgRows * cwg + 16 * (t >> 5) + ((t & 31) >> 2);
            const int col_a = uniform(it.n0) + 2 * (t & 3);
#pragma unroll
            for (int j = 0; j < kBN / 8; ++j) {
                const int c = col_a + 8 * j;
#pragma unroll
                for (int half = 0; half < 2; ++half) {
                    const int row = row_a + 8 * half;
                    float v[2];
#pragma unroll
                    for (int q = 0; q < 2; ++q) {
                        const float a = round_bf16(acc1[4 * j + 2 * half + q]);
                        if (MODE == kSwiGLU) {
                            const float u = round_bf16(acc2[4 * j + 2 * half + q]);
                            v[q] = round_bf16(silu(a)) * u;
                        } else if (MODE == kGelu) {
                            v[q] = gelu_tanh(a);
                        } else {
                            v[q] = a;
                        }
                    }
                    if (row < r1 && c < g.N)             // N % 8 == 0: c + 1 < N too
                        *reinterpret_cast<__nv_bfloat162*>(g.out + (int64_t)row * g.N + c) =
                            __floats2bfloat162_rn(v[0], v[1]);
                }
            }
        }
    }
}

// The launch's plan, from shapes alone (kernels/moe_experts/plan.py
// mirrors it): BM 128 where group 0's segments average 128 rows or more;
// the ring as deep as shared memory allows, at most 8; at most
// (rows0 / BM + n_exp) column-tile rows of items for group 0 (each expert
// adds at most one partial row tile) and ceil(rows1 / BM) for group 1; one
// block an SM, never more blocks than items.
struct Plan {
    int bm, stages, smem, grid;
    int64_t max_items;
};

int sm_count() {
    int dev = 0, n = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
        return 0;
    return n;
}

Plan make_plan(int mode, int rows0, int n_exp0, int N0, int rows1, int N1, int n_sms) {
    Plan pl;
    pl.bm = (int64_t)rows0 >= (int64_t)2 * kWgRows * n_exp0 ? 2 * kWgRows : kWgRows;
    pl.stages = ring_stages(mode, pl.bm, n_exp0);
    pl.smem = smem_bytes(mode, pl.bm, pl.stages, n_exp0);
    const int64_t nc0 = (N0 + kBN - 1) / kBN, nc1 = (N1 + kBN - 1) / kBN;
    pl.max_items = ((int64_t)rows0 / pl.bm + n_exp0) * nc0 +
                   (rows1 > 0 ? ((int64_t)rows1 + pl.bm - 1) / pl.bm * nc1 : 0);
    pl.grid = (int)(pl.max_items < n_sms ? pl.max_items : n_sms);
    return pl;
}

template <int MODE, int NWG>
cudaError_t launch(const Params& p, const Plan& pl, cudaStream_t stream) {
    cudaError_t e = cudaFuncSetAttribute(moe_experts_kernel<MODE, NWG>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, pl.smem);
    if (e != cudaSuccess) return e;
    moe_experts_kernel<MODE, NWG><<<pl.grid, 128 * (NWG + 1), pl.smem, stream>>>(p);
    return cudaGetLastError();
}

// x (rows, K) with a box of BM rows; w (n_exp, K, N) with a box of 64 k x
// 64 n of one expert.
bool encode_group(CUtensorMap* a, CUtensorMap* w1, CUtensorMap* w2, const void* x,
                  const void* w1p, const void* w2p, int rows, int n_exp, int K, int N, int bm) {
    const uint64_t da[2] = {(uint64_t)K, (uint64_t)rows}, sa[1] = {(uint64_t)K * 2};
    const uint32_t ba[2] = {kBK, (uint32_t)bm};
    const uint64_t dw[3] = {(uint64_t)N, (uint64_t)K, (uint64_t)n_exp};
    const uint64_t sw[2] = {(uint64_t)N * 2, (uint64_t)K * N * 2};
    const uint32_t bw[3] = {64, kBK, 1};
    if (rows > 0 && !encode_bf16_sw128(a, x, 2, da, sa, ba)) return false;
    if (!encode_bf16_sw128(w1, w1p, 3, dw, sw, bw)) return false;
    return w2p == nullptr || encode_bf16_sw128(w2, w2p, 3, dw, sw, bw);
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
// cudaErrorInvalidValue for a mode or shape the kernel does not take,
// cudaErrorNotSupported when the CUDA driver encodes no tensor map for it.
int moe_experts_launch(int mode, const void* x0, const void* offsets0, int rows0, int n_exp0,
                       const void* w1_0, const void* w2_0, void* out0, int K0, int N0,
                       const void* x1, int rows1, const void* w1_1, const void* w2_1,
                       void* out1, int K1, int N1, void* stream) {
    if (mode < 0 || mode > 2 || rows0 < 0 || n_exp0 < 1 || rows1 < 0 || K0 < 8 ||
        K0 % 8 || N0 < 8 || N0 % 8 || offsets0 == nullptr)
        return (int)cudaErrorInvalidValue;
    if (rows1 > 0 && (K1 < 8 || K1 % 8 || N1 < 8 || N1 % 8))
        return (int)cudaErrorInvalidValue;
    const bool two = mode == kSwiGLU;
    if (two != (w2_0 != nullptr) || (rows1 > 0 && two != (w2_1 != nullptr)))
        return (int)cudaErrorInvalidValue;
    const Plan pl = make_plan(mode, rows0, n_exp0, N0, rows1, N1, sm_count());
    if (pl.stages < 2 || pl.max_items > 0x7fffffff || pl.grid < 1)
        return (int)cudaErrorInvalidValue;
    Params p;
    memset(&p, 0, sizeof(p));
    p.g0 = {static_cast<__nv_bfloat16*>(out0), static_cast<const int*>(offsets0), rows0,
            n_exp0, K0, N0};
    p.g1 = {static_cast<__nv_bfloat16*>(out1), nullptr, rows1, 1, K1, N1};
    p.stages = pl.stages;
    if (!encode_group(&p.a0, &p.w1_0, &p.w2_0, x0, w1_0, w2_0, rows0, n_exp0, K0, N0, pl.bm))
        return (int)cudaErrorNotSupported;
    if (rows1 > 0 &&
        !encode_group(&p.a1, &p.w1_1, &p.w2_1, x1, w1_1, w2_1, rows1, 1, K1, N1, pl.bm))
        return (int)cudaErrorNotSupported;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const bool tall = pl.bm == 2 * kWgRows;
    switch (mode) {
        case kSwiGLU:
            return (int)(tall ? launch<kSwiGLU, 2>(p, pl, s) : launch<kSwiGLU, 1>(p, pl, s));
        case kGelu:
            return (int)(tall ? launch<kGelu, 2>(p, pl, s) : launch<kGelu, 1>(p, pl, s));
        default:
            return (int)(tall ? launch<kPlain, 2>(p, pl, s) : launch<kPlain, 1>(p, pl, s));
    }
}

// The plan moe_experts_launch makes for these shapes on the current
// device: out[0] rows per tile (BM), out[1] ring stages, out[2] dynamic
// shared memory bytes, out[3] blocks, out[4] the item bound the grid was
// sized from (clamped to 2^31 - 1).
int moe_experts_plan(int mode, int rows0, int n_exp0, int N0, int rows1, int N1, int* out) {
    if (mode < 0 || mode > 2 || rows0 < 0 || n_exp0 < 1 || rows1 < 0 || out == nullptr)
        return (int)cudaErrorInvalidValue;
    const Plan pl = make_plan(mode, rows0, n_exp0, N0, rows1, N1, sm_count());
    out[0] = pl.bm;
    out[1] = pl.stages;
    out[2] = pl.smem;
    out[3] = pl.grid;
    out[4] = (int)(pl.max_items < 0x7fffffff ? pl.max_items : 0x7fffffff);
    return 0;
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
