// Grouped expert FFN, routing and combine of a token-choice MoE layer for
// Hopper (sm_90a), bound through a plain C interface and loaded with ctypes
// (repro_torch/kernels/moe_experts/kernel.py).  A layer is four launches:
// route, the two expert launches (after one row gather), combine.
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

// Routing (moe_route_launch), one launch a layer.  The JAX package routes
// with an fp32 einsum, softmax, jax.lax.top_k and a renormalisation
// (src/repro/models/moe.py::moe_ffn); no Pallas kernel stands behind it.
// The launch writes the logits (T, E) = x (T, D) bf16 widened to fp32
// times w (D, E) fp32 on the CUDA cores (never TF32), the softmax, the
// top-k (ties to the lower expert) or the experts a caller forces, the k
// weights summed in order and divided by max(sum, 1e-9), and the stable
// counting sort of the T k pairs by expert: offsets, the pair at each
// sorted row (order, and its token), each pair's sorted row (pos) and its
// rank within its expert.  Each logit is one fixed-order sum (32 slices of
// D, each an FMA chain in d order, the slice sums added in slice order):
// bitwise the order of the earlier router kernel, and row-invariant, so a
// route cannot flip between a decode step and a chunk.  The grid, from
// shapes alone, splits a tile's 32 slices over up to 32 blocks while the
// tiles alone leave SMs idle (a decode step of 8 tokens runs on 32 SMs,
// not 2); the last block of a tile (an atomic counter) adds the slices
// and routes its tokens, and the last tile to finish sorts, then sets the
// counters back to 0 for the next launch.  Bound: at decode by latency
// (the bytes, 0.5 MB of weights, take 0.17 us); at 4096 tokens by fp32
// operations (1.07 GFLOP, 16 us at 67 TFLOP/s).  There the product, one
// token a lane and each weight a broadcast 16-byte shared-memory load
// (four wavefronts for 4 FMAs a lane), is held by shared-memory
// wavefronts, not by the FMA pipes.
//
// Combine (moe_combine_launch), one launch a layer: out (T, D) bf16 from
// the expert rows in sorted order, each pair's row found through pos,
// with the plain combine's roundings (each product bf16, the k products
// added in order in fp32, one rounding, then the shared expert's row
// added in bf16).  Elementwise per (token, column), so bitwise its plain
// version; bound by bytes (k + 2 rows of D bf16 a token).


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
    __nv_bfloat16* pre1;         // (rows, N) or null: bf16(x.W1), the SwiGLU gate or GELU up rows
    __nv_bfloat16* pre2;         // (rows, N) or null: bf16(x.W2), the SwiGLU up rows
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

// PRE (a training forward's gate/up launch) also stores the bf16
// pre-activations to g.pre1 / g.pre2; the serving instances (PRE false)
// compile without those stores.
template <int MODE, int NWG, bool PRE>
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
                    float v[2], a[2], u[2] = {0.f, 0.f};
#pragma unroll
                    for (int q = 0; q < 2; ++q) {
                        a[q] = round_bf16(acc1[4 * j + 2 * half + q]);
                        if (MODE == kSwiGLU) {
                            u[q] = round_bf16(acc2[4 * j + 2 * half + q]);
                            v[q] = round_bf16(silu(a[q])) * u[q];
                        } else if (MODE == kGelu) {
                            v[q] = gelu_tanh(a[q]);
                        } else {
                            v[q] = a[q];
                        }
                    }
                    if (row < r1 && c < g.N) {           // N % 8 == 0: c + 1 < N too
                        const int64_t o = (int64_t)row * g.N + c;
                        *reinterpret_cast<__nv_bfloat162*>(g.out + o) =
                            __floats2bfloat162_rn(v[0], v[1]);
                        // the pre-activations the backward reads (a training forward)
                        if (PRE && g.pre1 != nullptr)
                            *reinterpret_cast<__nv_bfloat162*>(g.pre1 + o) =
                                __floats2bfloat162_rn(a[0], a[1]);
                        if (PRE && MODE == kSwiGLU && g.pre2 != nullptr)
                            *reinterpret_cast<__nv_bfloat162*>(g.pre2 + o) =
                                __floats2bfloat162_rn(u[0], u[1]);
                    }
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

template <int MODE, int NWG, bool PRE>
cudaError_t launch_one(const Params& p, const Plan& pl, cudaStream_t stream) {
    cudaError_t e = cudaFuncSetAttribute(moe_experts_kernel<MODE, NWG, PRE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, pl.smem);
    if (e != cudaSuccess) return e;
    moe_experts_kernel<MODE, NWG, PRE><<<pl.grid, 128 * (NWG + 1), pl.smem, stream>>>(p);
    return cudaGetLastError();
}

template <int MODE, bool PRE>
cudaError_t launch(const Params& p, const Plan& pl, cudaStream_t stream) {
    return pl.bm == 2 * kWgRows ? launch_one<MODE, 2, PRE>(p, pl, stream)
                                : launch_one<MODE, 1, PRE>(p, pl, stream);
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

// -- routing and combine ------------------------------------------------------------

constexpr int kRouteSlices = 32;     // slices of D, each one FMA chain, summed in order
constexpr int kRouteThreads = 512;
constexpr int kRouteStages = 3;      // cp.async ring of slices
constexpr int kRouteMaxE = 128;
constexpr int kRouteMaxK = 32;
constexpr int kRouteMaxD = 4096;
constexpr int kRouteTilePairs = 2048;  // tt k is at most this for every E
constexpr int kRouteScanInts = 1024;   // the sort's buffer of tile counts
constexpr int kRouteSortSmem = 160 * 1024;  // the sort builds `order` in shared memory up to this
constexpr int kRouteCounters = 256;  // ints of the counter buffer: one a tile, the last global
constexpr int kRouteSortBatch = 8;   // pairs a thread scatters at a time in the sort
constexpr int kRouteStaticSmem = (kRouteTilePairs + kRouteMaxE + 4) * 4;

// The launch's shape, from (T, D, E, k) and the SM count alone.  A lane
// is a token; a thread holds 4 ce experts of it (the experts padded to ep
// = 4 eq, a power of two, split over wq warps), so a warp reads each
// weight once for its 32 tokens (a broadcast) and each token's x pair
// once (rows padded to an odd word stride: no bank conflict).  The 32
// slices of a tile go to `groups` blocks (groups > 1 only while tiles x
// groups fill at most the SMs), whose partial sums meet in the
// workspace.  The dynamic shared memory holds the slice ring, then
// (reused) the tile's logits, then in the last block the sort.
struct RouteShape {
    int eq, ep, wq, ce, tt, n_tiles, groups, slice, xs_words, x_bytes, stage_bytes, smem;
    bool sort_smem, table_smem;
    int64_t part_floats, ws_bytes;
};

RouteShape route_shape(int T, int D, int E, int k, int sms) {
    RouteShape s;
    s.eq = 1;
    while (4 * s.eq < E) s.eq *= 2;
    s.ep = 4 * s.eq;
    s.wq = min(kRouteThreads / 32, s.eq);
    s.ce = s.eq / s.wq;
    s.tt = 32 * (kRouteThreads / 32 / s.wq);
    s.n_tiles = (T + s.tt - 1) / s.tt;
    s.groups = 1;
    while (s.groups < kRouteSlices && (int64_t)s.n_tiles * s.groups * 2 <= sms) s.groups *= 2;
    s.slice = (((D + kRouteSlices - 1) / kRouteSlices) + 1) & ~1;
    s.xs_words = s.slice / 2 + 1;
    s.x_bytes = (s.tt * s.xs_words * 4 + 15) & ~15;
    s.stage_bytes = s.x_bytes + s.slice * s.ep * 4;
    // the sort's shared memory: `order` (T k ints) and the tiles' counts
    // (n_tiles E ints, else a chunk of them), each where it fits
    const int64_t order_bytes = (int64_t)T * k * 4, table_bytes = (int64_t)s.n_tiles * E * 4;
    s.sort_smem = order_bytes + kRouteScanInts * 4 <= kRouteSortSmem;
    s.table_smem = s.sort_smem && order_bytes + max(table_bytes, (int64_t)kRouteScanInts * 4) <=
                                      kRouteSortSmem;
    const int64_t sort_bytes = (s.sort_smem ? order_bytes : 0) +
                               (s.table_smem ? max(table_bytes, (int64_t)kRouteScanInts * 4)
                                             : kRouteScanInts * 4);
    s.smem = max(kRouteStages * s.stage_bytes, s.tt * s.ep * 4);
    s.smem = max(s.smem, (int)sort_bytes);
    s.part_floats = s.groups > 1 ? (int64_t)kRouteSlices * s.n_tiles * s.tt * s.ep : 0;
    s.ws_bytes = s.part_floats * 4 + (int64_t)s.n_tiles * E * 4;
    return s;
}

struct RouteParams {
    const __nv_bfloat16* x;      // (T, D)
    const float* w;              // (D, E)
    const int* forced;           // (T, k) or null
    float* logits;               // (T, E)
    float* gates;                // (T, E)
    float* weights;              // (T, k)
    int* idx;                    // (T, k)
    int* offsets;                // (E + 1,)
    int* order;                  // (P,) pair at each sorted row
    int* tok;                    // (P,) its token
    int* pos;                    // (P,) each pair's sorted row
    int* rank;                   // (P,) rank within its expert (the tile's rank until the sort)
    float* part;                 // (32, n_tiles tt, ep) when groups > 1
    int* hist;                   // (n_tiles, E)
    int* counters;               // (kRouteCounters,), zero between launches
    int T, D, E, k;
    bool w_vec;                  // w's rows staged by 16-byte copies (else 4-byte)
    RouteShape s;
};

template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
    if constexpr (BYTES == 16)
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src)
                     : "memory");
    else
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(dst)), "l"(src)
                     : "memory");
}

__device__ __forceinline__ void cp_async_commit_group() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_ring() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kRouteStages - 1) : "memory");
}

// rows x cpr chunks of BYTES from src (row stride src_ld bytes; rows past
// last_row read last_row) to dst (row stride dst_ld), by cp.async.
template <int BYTES>
__device__ __forceinline__ void stage_rows(unsigned char* dst, int dst_ld, const unsigned char* src,
                                           int64_t src_ld, int rows, int last_row, int cpr) {
    const int dr = kRouteThreads / cpr, dc = kRouteThreads - dr * cpr;
    int r = threadIdx.x / cpr, c = threadIdx.x - r * cpr;
    for (int i = threadIdx.x; i < rows * cpr; i += kRouteThreads) {
        cp_async<BYTES>(dst + r * dst_ld + c * BYTES,
                        src + (int64_t)min(r, last_row) * src_ld + c * BYTES);
        r += dr;
        c += dc;
        if (c >= cpr) {
            c -= cpr;
            ++r;
        }
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

// Slice sl's rows of x (the tile's tt tokens, clamped to T - 1) and of w
// into one stage: x as bf16 pairs (tt, xs_words), w as fp32 (slice, ep);
// one cp.async group (empty past D).
__device__ __forceinline__ void route_stage(const RouteParams& p, int t0, int sl,
                                            unsigned char* stage) {
    const RouteShape& s = p.s;
    const int d0 = min(p.D, sl * s.slice), len = min(p.D, d0 + s.slice) - d0;
    if (len > 0) {
        const unsigned char* xs =
            reinterpret_cast<const unsigned char*>(p.x + (int64_t)t0 * p.D + d0);
        const unsigned char* ws = reinterpret_cast<const unsigned char*>(p.w + (int64_t)d0 * p.E);
        stage_rows<4>(stage, s.xs_words * 4, xs, (int64_t)p.D * 2, s.tt, p.T - 1 - t0, len / 2);
        if (p.w_vec)
            stage_rows<16>(stage + s.x_bytes, s.ep * 4, ws, (int64_t)p.E * 4, len, len - 1,
                           p.E / 4);
        else
            stage_rows<4>(stage + s.x_bytes, s.ep * 4, ws, (int64_t)p.E * 4, len, len - 1, p.E);
    }
    cp_async_commit_group();
}

// Softmax, top-k (or the forced experts) and the renormalised weights of
// token t, one warp; lg holds its logits (E floats) and takes its gates,
// sel its k experts.  The top-k ranks every gate by counting the gates
// above it (ties: the lower expert first, jax.lax.top_k's order).
__device__ void route_token(const RouteParams& p, int t, float* lg, int* sel) {
    const int lane = threadIdx.x & 31, E = p.E, k = p.k;
    float v[kRouteMaxE / 32];
    float m = -INFINITY;
#pragma unroll
    for (int c = 0; c < kRouteMaxE / 32; ++c) {
        const int e = lane + 32 * c;
        v[c] = e < E ? lg[e] : -INFINITY;
        m = fmaxf(m, v[c]);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    float sum = 0.f;
#pragma unroll
    for (int c = 0; c < kRouteMaxE / 32; ++c) {
        const int e = lane + 32 * c;
        const float ex = e < E ? expf(v[c] - m) : 0.f;
        if (e < E) p.logits[(int64_t)t * E + e] = v[c];
        v[c] = ex;
        sum += ex;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
#pragma unroll
    for (int c = 0; c < kRouteMaxE / 32; ++c) {
        const int e = lane + 32 * c;
        if (e < E) {
            v[c] = v[c] / sum;
            p.gates[(int64_t)t * E + e] = v[c];
            lg[e] = v[c];
        }
    }
    if (lane < k) sel[lane] = 0;     // a slot no gate claims (NaN gates) stays in range
    __syncwarp();
    if (p.forced != nullptr) {
        if (lane < k) sel[lane] = min(max(p.forced[(int64_t)t * k + lane], 0), E - 1);
    } else {
        int above[kRouteMaxE / 32] = {};
        for (int f = 0; f < E; ++f) {
            const float h = lg[f];
#pragma unroll
            for (int c = 0; c < kRouteMaxE / 32; ++c)
                above[c] += (h > v[c]) | ((h == v[c]) & (f < lane + 32 * c));
        }
#pragma unroll
        for (int c = 0; c < kRouteMaxE / 32; ++c)
            if (lane + 32 * c < E && above[c] < k) sel[above[c]] = lane + 32 * c;
    }
    __syncwarp();
    const int my_i = lane < k ? sel[lane] : 0;
    const float my_w = lane < k ? lg[my_i] : 0.f;
    // the k weights summed in order j = 0..k-1 in fp32, then max(sum, 1e-9)
    float s = 0.f;
    for (int j = 0; j < k; ++j) {
        const float wj = __shfl_sync(0xffffffffu, my_w, j);
        s = j == 0 ? wj : __fadd_rn(s, wj);
    }
    const float den = s < 1e-9f ? 1e-9f : s;
    if (lane < k) {
        p.weights[(int64_t)t * k + lane] = __fdiv_rn(my_w, den);
        p.idx[(int64_t)t * k + lane] = my_i;
    }
}

// The stable counting sort of the P = T k pairs by expert, in the last
// block: hist's tile counts become each tile's base within its expert (a
// scan over the tiles in order), the totals the offsets, and each pair's
// sorted row is offsets[e] + its tile's base + its rank within the tile.
// Where they fit, the bases stay in shared memory and `order` is built
// there, then written out in order with `tok`.
__device__ void route_sort(const RouteParams& p, int* dyn, int* cnt) {
    const RouteShape& s = p.s;
    const int E = p.E, k = p.k, tid = threadIdx.x;
    const int P = p.T * k;
    int* order_s = dyn;
    int* buf = s.sort_smem ? dyn + P : dyn;
    const int ch = s.table_smem ? s.n_tiles : max(1, kRouteScanInts / E);
    int run = 0;
    for (int c0 = 0; c0 < s.n_tiles; c0 += ch) {
        const int nt = min(ch, s.n_tiles - c0);
#pragma unroll 4
        for (int i = tid; i < nt * E; i += kRouteThreads)
            buf[i] = __ldcg(p.hist + (int64_t)c0 * E + i);
        __syncthreads();
        if (tid < E) {
            for (int j = 0; j < nt; ++j) {
                const int h = buf[j * E + tid];
                buf[j * E + tid] = run;
                run += h;
            }
        }
        __syncthreads();
        if (s.table_smem) break;
#pragma unroll 4
        for (int i = tid; i < nt * E; i += kRouteThreads) p.hist[(int64_t)c0 * E + i] = buf[i];
        __syncthreads();
    }
    if (tid < E) cnt[tid] = run;
    __syncthreads();
    // offsets: an exclusive scan of the totals over the experts, by warp 0
    if (tid < 32) {
        int carry = 0;
        for (int e0 = 0; e0 < E; e0 += 32) {
            const int e = e0 + tid;
            const int c = e < E ? cnt[e] : 0;
            int incl = c;
#pragma unroll
            for (int o = 1; o < 32; o <<= 1) {
                const int n = __shfl_up_sync(0xffffffffu, incl, o);
                if (tid >= o) incl += n;
            }
            if (e < E) {
                cnt[e] = carry + incl - c;
                p.offsets[e] = carry + incl - c;
            }
            carry += __shfl_sync(0xffffffffu, incl, 31);
        }
        if (tid == 0) p.offsets[E] = carry;
    }
    __syncthreads();
    // kRouteSortBatch pairs a thread at a time, every load of a batch issued
    // before its stores
    for (int b = tid; b < P; b += kRouteThreads * kRouteSortBatch) {
        int e[kRouteSortBatch], at[kRouteSortBatch];
#pragma unroll
        for (int j = 0; j < kRouteSortBatch; ++j) {
            const int q = b + j * kRouteThreads;
            e[j] = q < P ? __ldcg(p.idx + q) : 0;
            at[j] = q < P ? __ldcg(p.rank + q) : 0;
        }
#pragma unroll
        for (int j = 0; j < kRouteSortBatch; ++j) {
            const int q = b + j * kRouteThreads;
            if (q < P) {
                const int64_t h = (int64_t)((q / k) / s.tt) * E + e[j];
                at[j] += cnt[e[j]] + (s.table_smem ? buf[h] : __ldcg(p.hist + h));
            }
        }
#pragma unroll
        for (int j = 0; j < kRouteSortBatch; ++j) {
            const int q = b + j * kRouteThreads;
            if (q < P) {
                if (s.sort_smem) {
                    order_s[at[j]] = q;
                } else {
                    p.order[at[j]] = q;
                    p.tok[at[j]] = q / k;
                }
                p.pos[q] = at[j];
                p.rank[q] = at[j] - cnt[e[j]];
            }
        }
    }
    if (s.sort_smem) {
        __syncthreads();
        for (int i = tid; i < P; i += kRouteThreads) {
            const int q = order_s[i];
            p.order[i] = q;
            p.tok[i] = q / k;
        }
    }
}

// One launch of the layer's routing: grid (n_tiles, groups).  Each block
// takes its group's slices of one tile of tokens through a three-stage
// cp.async ring and keeps one FMA chain a slice for every (token,
// expert), d in order (as the earlier router kernel); the slice sums are
// added in slice order, in registers (groups == 1) or, from the
// workspace, by the last of the tile's blocks.  That block routes its
// tile's tokens (a warp a token) and ranks its pairs within their experts
// in pair order (__match_any_sync, 32 pairs at a time); the last tile to
// finish sorts.
template <int CE>
__global__ void __launch_bounds__(kRouteThreads) moe_route_kernel(const RouteParams p) {
    extern __shared__ __align__(16) unsigned char smem[];
    __shared__ int tile_idx[kRouteTilePairs];     // the tile's pairs' experts
    __shared__ int cnt[kRouteMaxE];
    __shared__ int flag;
    const RouteShape& s = p.s;
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int tile = blockIdx.x, t0 = tile * s.tt;
    const int tl = (warp / s.wq) * 32 + lane, cb = (warp % s.wq) * CE;  // token, first chunk
    const int spg = kRouteSlices / s.groups, s_lo = blockIdx.y * spg;
    const int64_t n_rows = (int64_t)s.n_tiles * s.tt;

    float run[CE][4];
    for (int i = 0; i < kRouteStages - 1; ++i) {
        if (i < spg) route_stage(p, t0, s_lo + i, smem + i * s.stage_bytes);
        else cp_async_commit_group();
    }
    for (int i = 0; i < spg; ++i) {
        const int sl = s_lo + i, ahead = i + kRouteStages - 1;
        if (ahead < spg)
            route_stage(p, t0, s_lo + ahead, smem + (ahead % kRouteStages) * s.stage_bytes);
        else
            cp_async_commit_group();
        cp_async_wait_ring();
        __syncthreads();
        const unsigned char* st = smem + (i % kRouteStages) * s.stage_bytes;
        const __nv_bfloat162* xs = reinterpret_cast<const __nv_bfloat162*>(st) + tl * s.xs_words;
        const float* ws = reinterpret_cast<const float*>(st + s.x_bytes) + 4 * cb;
        const int d0 = min(p.D, sl * s.slice), len = min(p.D, d0 + s.slice) - d0;
        float acc[CE][4];
#pragma unroll
        for (int c = 0; c < CE; ++c)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[c][j] = 0.f;
#pragma unroll 4
        for (int d = 0; d < len; d += 2) {      // len even
            const float2 xv = __bfloat1622float2(xs[d / 2]);
#pragma unroll
            for (int c = 0; c < CE; ++c) {
                const float4 w0 = *reinterpret_cast<const float4*>(ws + d * s.ep + 4 * c);
                const float4 w1 = *reinterpret_cast<const float4*>(ws + (d + 1) * s.ep + 4 * c);
                acc[c][0] = fmaf(xv.x, w0.x, acc[c][0]);
                acc[c][0] = fmaf(xv.y, w1.x, acc[c][0]);
                acc[c][1] = fmaf(xv.x, w0.y, acc[c][1]);
                acc[c][1] = fmaf(xv.y, w1.y, acc[c][1]);
                acc[c][2] = fmaf(xv.x, w0.z, acc[c][2]);
                acc[c][2] = fmaf(xv.y, w1.z, acc[c][2]);
                acc[c][3] = fmaf(xv.x, w0.w, acc[c][3]);
                acc[c][3] = fmaf(xv.y, w1.w, acc[c][3]);
            }
        }
        if (s.groups == 1) {
#pragma unroll
            for (int c = 0; c < CE; ++c)
#pragma unroll
                for (int j = 0; j < 4; ++j)
                    run[c][j] = i == 0 ? acc[c][j] : __fadd_rn(run[c][j], acc[c][j]);
        } else {
#pragma unroll
            for (int c = 0; c < CE; ++c)
                *reinterpret_cast<float4*>(p.part + ((int64_t)sl * n_rows + t0 + tl) * s.ep +
                                           4 * (cb + c)) =
                    make_float4(acc[c][0], acc[c][1], acc[c][2], acc[c][3]);
        }
        __syncthreads();        // the stage is refilled next
    }

    float* lg = reinterpret_cast<float*>(smem);     // (tt, ep): the ring is done
    const int n_valid = min(s.tt, p.T - t0);
    if (s.groups == 1) {
#pragma unroll
        for (int c = 0; c < CE; ++c)
#pragma unroll
            for (int j = 0; j < 4; ++j) lg[tl * s.ep + 4 * (cb + c) + j] = run[c][j];
    } else {
        if (!last_to_arrive(p.counters + tile, s.groups, &flag)) return;
#pragma unroll 4
        for (int i = tid; i < n_valid * p.E; i += kRouteThreads) {
            const int r = i / p.E, e = i - r * p.E;
            const float* src = p.part + (int64_t)(t0 + r) * s.ep + e;
            float sum = __ldcg(src);
#pragma unroll
            for (int sl = 1; sl < kRouteSlices; ++sl)
                sum = __fadd_rn(sum, __ldcg(src + sl * n_rows * s.ep));
            lg[r * s.ep + e] = sum;
        }
    }
    __syncthreads();
    for (int r = warp; r < n_valid; r += kRouteThreads / 32)
        route_token(p, t0 + r, lg + r * s.ep, tile_idx + r * p.k);
    for (int e = tid; e < p.E; e += kRouteThreads) cnt[e] = 0;
    __syncthreads();
    if (warp == 0) {
        const int n = n_valid * p.k;
        for (int b = 0; b < n; b += 32) {
            const int q = b + lane;
            const bool ok = q < n;
            const int e = ok ? tile_idx[q] : -1 - lane;
            const unsigned mask = __match_any_sync(0xffffffffu, e);
            const int before = __popc(mask & ((1u << lane) - 1u));
            const int c0 = ok ? cnt[e] : 0;
            __syncwarp();
            if (ok) {
                p.rank[(int64_t)t0 * p.k + q] = c0 + before;
                if (before == 0) cnt[e] = c0 + __popc(mask);
            }
            __syncwarp();
        }
    }
    __syncthreads();
    for (int e = tid; e < p.E; e += kRouteThreads) p.hist[(int64_t)tile * p.E + e] = cnt[e];
    if (!last_to_arrive(p.counters + kRouteCounters - 1, s.n_tiles, &flag)) return;
    route_sort(p, reinterpret_cast<int*>(smem), cnt);
}

// out (T, D) = bf16(sum_j bf16(ys[pos[t k + j]] * bf16(weights[t, j]))), the
// k products added in order in fp32 (a dropped pair's product is
// bf16(0 * w)), then bf16(out + y_shared): the roundings of the plain
// combine.  A thread takes 8 columns of one token (16-byte loads/stores).
__global__ void __launch_bounds__(128)
moe_combine_kernel(const __nv_bfloat16* __restrict__ ys, const int* __restrict__ pos,
                   const float* __restrict__ weights, const unsigned char* __restrict__ kept,
                   const __nv_bfloat16* __restrict__ y_shared, __nv_bfloat16* __restrict__ out,
                   int T, int D, int k) {
    const int nv = D / 8;
    const int64_t v = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (v >= (int64_t)T * nv) return;
    const int t = (int)(v / nv), c = (int)(v - (int64_t)t * nv) * 8;
    float acc[8];
    for (int j = 0; j < k; ++j) {
        const int64_t q = (int64_t)t * k + j;
        const float wb = __bfloat162float(__float2bfloat16_rn(__ldg(weights + q)));
        const bool keep = kept == nullptr || __ldg(kept + q) != 0;
        uint4 raw = make_uint4(0u, 0u, 0u, 0u);
        if (keep) raw = __ldg(reinterpret_cast<const uint4*>(ys + (int64_t)__ldg(pos + q) * D + c));
        const __nv_bfloat16* y = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
            const float prod = __bfloat162float(
                __float2bfloat16_rn(__fmul_rn(__bfloat162float(y[i]), wb)));
            acc[i] = j == 0 ? prod : __fadd_rn(acc[i], prod);
        }
    }
    uint4 res;
    __nv_bfloat16* o = reinterpret_cast<__nv_bfloat16*>(&res);
    uint4 sh = make_uint4(0u, 0u, 0u, 0u);
    if (y_shared != nullptr)
        sh = __ldg(reinterpret_cast<const uint4*>(y_shared + (int64_t)t * D + c));
    const __nv_bfloat16* ysh = reinterpret_cast<const __nv_bfloat16*>(&sh);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        o[i] = __float2bfloat16_rn(acc[i]);
        if (y_shared != nullptr)
            o[i] = __float2bfloat16_rn(__fadd_rn(__bfloat162float(o[i]), __bfloat162float(ysh[i])));
    }
    *reinterpret_cast<uint4*>(out + (int64_t)t * D + c) = res;
}

template <int CE>
cudaError_t launch_route(const RouteParams& p, cudaStream_t stream) {
    cudaError_t e = cudaFuncSetAttribute(moe_route_kernel<CE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, p.s.smem);
    if (e != cudaSuccess) return e;
    moe_route_kernel<CE><<<dim3(p.s.n_tiles, p.s.groups), kRouteThreads, p.s.smem, stream>>>(p);
    return cudaGetLastError();
}

}  // namespace

extern "C" {

// mode: 0 SwiGLU gate/up (w1 gate, w2 up), 1 GELU up (w1), 2 plain (w1).
// Group 0 is the routed pairs: x0 (rows0, K0), offsets0 (n_exp0 + 1,) int32
// on the device, w1_0 / w2_0 (n_exp0, K0, N0), out0 (rows0, N0).  Group 1,
// when rows1 > 0, is one expert over rows1 rows: x1 (rows1, K1), w1_1 /
// w2_1 (K1, N1), out1 (rows1, N1).  All bf16, contiguous, 16-byte aligned;
// K and N multiples of 8.  pre1_g and pre2_g, (rows_g, N_g) bf16 or null,
// take the bf16 pre-activations x.W1 and x.W2 (SwiGLU) or x.W1 (GELU) of
// a gate/up launch for the backward (not the plain mode); any of them
// selects the kernel's instance with those stores, and the output is the
// same with or without them.  Returns a cudaError_t: 0 on success,
// cudaErrorInvalidValue for a mode or shape the kernel does not take,
// cudaErrorNotSupported when the CUDA driver encodes no tensor map for it.
int moe_experts_launch(int mode, const void* x0, const void* offsets0, int rows0, int n_exp0,
                       const void* w1_0, const void* w2_0, void* out0, int K0, int N0,
                       const void* x1, int rows1, const void* w1_1, const void* w2_1,
                       void* out1, int K1, int N1, void* pre1_0, void* pre2_0, void* pre1_1,
                       void* pre2_1, void* stream) {
    if (mode < 0 || mode > 2 || rows0 < 0 || n_exp0 < 1 || rows1 < 0 || K0 < 8 ||
        K0 % 8 || N0 < 8 || N0 % 8 || offsets0 == nullptr)
        return (int)cudaErrorInvalidValue;
    if (rows1 > 0 && (K1 < 8 || K1 % 8 || N1 < 8 || N1 % 8))
        return (int)cudaErrorInvalidValue;
    const bool two = mode == kSwiGLU;
    if (two != (w2_0 != nullptr) || (rows1 > 0 && two != (w2_1 != nullptr)))
        return (int)cudaErrorInvalidValue;
    const bool pre = pre1_0 != nullptr || pre2_0 != nullptr || pre1_1 != nullptr ||
                     pre2_1 != nullptr;
    if (pre && mode == kPlain) return (int)cudaErrorInvalidValue;
    const Plan pl = make_plan(mode, rows0, n_exp0, N0, rows1, N1, sm_count());
    if (pl.stages < 2 || pl.max_items > 0x7fffffff || pl.grid < 1)
        return (int)cudaErrorInvalidValue;
    Params p;
    memset(&p, 0, sizeof(p));
    p.g0 = {static_cast<__nv_bfloat16*>(out0), static_cast<const int*>(offsets0),
            static_cast<__nv_bfloat16*>(pre1_0), static_cast<__nv_bfloat16*>(pre2_0), rows0,
            n_exp0, K0, N0};
    p.g1 = {static_cast<__nv_bfloat16*>(out1), nullptr, static_cast<__nv_bfloat16*>(pre1_1),
            static_cast<__nv_bfloat16*>(pre2_1), rows1, 1, K1, N1};
    p.stages = pl.stages;
    if (!encode_group(&p.a0, &p.w1_0, &p.w2_0, x0, w1_0, w2_0, rows0, n_exp0, K0, N0, pl.bm))
        return (int)cudaErrorNotSupported;
    if (rows1 > 0 &&
        !encode_group(&p.a1, &p.w1_1, &p.w2_1, x1, w1_1, w2_1, rows1, 1, K1, N1, pl.bm))
        return (int)cudaErrorNotSupported;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (mode) {
        case kSwiGLU:
            return (int)(pre ? launch<kSwiGLU, true>(p, pl, s) : launch<kSwiGLU, false>(p, pl, s));
        case kGelu:
            return (int)(pre ? launch<kGelu, true>(p, pl, s) : launch<kGelu, false>(p, pl, s));
        default:
            return (int)launch<kPlain, false>(p, pl, s);
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

// The shape moe_route_launch takes for (T, D, E, k) on the current device:
// out[0] tokens a tile, out[1] blocks a tile (slice groups), out[2] tiles,
// out[3] dynamic shared memory bytes, out[4] workspace bytes (clamped to
// 2^31 - 1), out[5] experts a thread.  T >= 1, D even and at most 4096, 1 <=
// k <= E <= 128, k <= 32.
int moe_route_plan(int T, int D, int E, int k, int* out) {
    if (T < 1 || D < 2 || D % 2 || D > kRouteMaxD || E < 1 || E > kRouteMaxE || k < 1 ||
        k > E || k > kRouteMaxK || out == nullptr)
        return (int)cudaErrorInvalidValue;
    const RouteShape s = route_shape(T, D, E, k, sm_count());
    out[0] = s.tt;
    out[1] = s.groups;
    out[2] = s.n_tiles;
    out[3] = s.smem;
    out[4] = (int)(s.ws_bytes < 0x7fffffff ? s.ws_bytes : 0x7fffffff);
    out[5] = 4 * s.ce;
    return 0;
}

// One launch of a layer's routing (see moe_route_kernel): x (T, D) bf16 (4-byte
// aligned), w (D, E) fp32, forced (T, k) int32 or null -> logits, gates (T,
// E) fp32, weights (T, k) fp32, idx (T, k) int32, offsets (E + 1,), order,
// tok, pos, rank (T k,) int32.  workspace holds moe_route_plan's bytes;
// counters, kRouteCounters int32 zeros on the device, are left zero again by
// every launch that completes (launches sharing them must not overlap).
int moe_route_launch(const void* x, const void* w, const void* forced, void* logits,
                     void* gates, void* weights, void* idx, void* offsets, void* order,
                     void* tok, void* pos, void* rank, void* workspace, void* counters, int T,
                     int D, int E, int k, void* stream) {
    if (T < 1 || D < 2 || D % 2 || D > kRouteMaxD || E < 1 || E > kRouteMaxE || k < 1 ||
        k > E || k > kRouteMaxK || (reinterpret_cast<uintptr_t>(x) & 3) ||
        (reinterpret_cast<uintptr_t>(workspace) & 15) || counters == nullptr)
        return (int)cudaErrorInvalidValue;
    RouteParams p;
    p.s = route_shape(T, D, E, k, sm_count());
    if ((int64_t)T * k > 0x7fffffff || p.s.smem + kRouteStaticSmem > kSmemLimit ||
        (p.s.groups > 1 && p.s.n_tiles >= kRouteCounters))
        return (int)cudaErrorInvalidValue;
    p.x = static_cast<const __nv_bfloat16*>(x);
    p.w = static_cast<const float*>(w);
    p.forced = static_cast<const int*>(forced);
    p.logits = static_cast<float*>(logits);
    p.gates = static_cast<float*>(gates);
    p.weights = static_cast<float*>(weights);
    p.idx = static_cast<int*>(idx);
    p.offsets = static_cast<int*>(offsets);
    p.order = static_cast<int*>(order);
    p.tok = static_cast<int*>(tok);
    p.pos = static_cast<int*>(pos);
    p.rank = static_cast<int*>(rank);
    p.part = static_cast<float*>(workspace);
    p.hist = reinterpret_cast<int*>(static_cast<float*>(workspace) + p.s.part_floats);
    p.counters = static_cast<int*>(counters);
    p.T = T;
    p.D = D;
    p.E = E;
    p.k = k;
    p.w_vec = E % 4 == 0 && !(reinterpret_cast<uintptr_t>(w) & 15);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    switch (p.s.ce) {
        case 4: return (int)launch_route<4>(p, st);
        case 2: return (int)launch_route<2>(p, st);
        default: return (int)launch_route<1>(p, st);
    }
}

// out (T, D) bf16 = the weighted sum of each token's k expert rows (see
// moe_combine_kernel): ys (P, D) bf16 in expert order, pos (T k,) int32,
// weights (T, k) fp32, kept (T k,) bytes or null, y_shared (T, D) bf16 or
// null.  D a multiple of 8; ys, y_shared and out 16-byte aligned.
int moe_combine_launch(const void* ys, const void* pos, const void* weights, const void* kept,
                       const void* y_shared, void* out, int T, int D, int k, void* stream) {
    const uintptr_t mis = reinterpret_cast<uintptr_t>(ys) | reinterpret_cast<uintptr_t>(out) |
                          reinterpret_cast<uintptr_t>(y_shared);
    if (T < 1 || D < 8 || D % 8 || k < 1 || (mis & 15)) return (int)cudaErrorInvalidValue;
    const int64_t blocks = ((int64_t)T * (D / 8) + 127) / 128;
    if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
    moe_combine_kernel<<<(unsigned)blocks, 128, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const __nv_bfloat16*>(ys), static_cast<const int*>(pos),
        static_cast<const float*>(weights), static_cast<const unsigned char*>(kept),
        static_cast<const __nv_bfloat16*>(y_shared), static_cast<__nv_bfloat16*>(out), T, D, k);
    return (int)cudaGetLastError();
}

const char* moe_experts_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
