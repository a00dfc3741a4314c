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

// Routing (moe_route_launch): the JAX package routes with an fp32 einsum,
// softmax, jax.lax.top_k and a renormalisation
// (src/repro/models/moe.py::moe_ffn); no Pallas kernel stands behind it.
// One launch writes the logits (T, E) = x (T, D) bf16 widened to fp32 times
// w (D, E) fp32 on the CUDA cores (never TF32), the softmax, the top-k
// (ties to the lower expert) or the experts a caller forces, the k weights
// summed in order and divided by max(sum, 1e-9), and each pair's rank
// within its expert in its tile; a tile's block also sorts when one tile
// holds every token, else a second launch (moe_route_sort_kernel) does:
// the stable counting sort of the T k pairs by expert (offsets, the pair
// at each sorted row and its token, each pair's sorted row and rank).
// Each logit is one fixed-order sum (32 slices of D, each an FMA chain in
// d order from 0, the slice sums added in slice order): bitwise the order
// of the earlier router kernels, and row-invariant, so a route cannot flip
// between a decode step and a chunk.  The softmax's sum is taken in the
// order of a warp's xor reduction over 32 lanes of up to 4 experts each
// (the earlier kernel's), so the gates stay bitwise too.  Bound: at decode
// by latency (the bytes, 0.5 MB of weights, take 0.17 us); at 4096 tokens
// by fp32 operations (1.07 GFLOP, 16 us at 67 TFLOP/s).  The product is
// register-tiled: a thread holds 8 tokens x 8 experts of one slice (2
// tokens at small T), so one shared-memory load of w (a float4) feeds 32
// FMAs and one of x (a bf16 pair) 16; a block's 8 warps take 8 slices of
// the same tokens at once and fold each round's chains in slice order
// through shared memory.  A ninth warp issues the ring's stages by TMA
// (full and empty mbarriers), so the loads overlap the products.  The
// grid, from shapes alone, splits a tile's slices over blocks while the
// tiles alone would leave SMs idle; the last block of a tile (an atomic
// counter) adds the slices from the workspace.  The serial rest runs a warp
// a token, up to 4 tokens of a warp at once: the softmax, the top-k as k
// rounds of a warp argmax, the weights; the 8 warps rank an eighth of the
// tile's pairs each.  Counters are left at 0, so a launch is capturable.

// Combine (moe_combine_launch), one launch a layer: out (T, D) bf16 from
// the expert rows in sorted order, each pair's row found through pos,
// with the plain combine's roundings (each product bf16, the k products
// added in order in fp32, one rounding, then the shared expert's row
// added in bf16).  Elementwise per (token, column), so bitwise its plain
// version; bound by bytes (k + 2 rows of D bf16 a token).  Its partial
// mode (moe_combine_partial_launch, an expert shard's part under a mesh)
// stores the fp32 sum uncast and adds no shared row (k rows of D bf16 in,
// one of D fp32 out a token).


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
constexpr int kRouteThreads = 256;           // the routing launch's compute threads (8 warps)
constexpr int kRouteWarps = kRouteThreads / 32;
constexpr int kRouteBlock = kRouteThreads + 32;  // and one producer warp issuing the TMA stages
constexpr int kRouteStages = 3;      // the ring of stages (TMA or cp.async) at most
constexpr int kRouteMaxE = 128;
constexpr int kRouteMaxK = 32;
constexpr int kRouteMaxD = 4096;
constexpr int kRouteStageCap = 32 * 1024;    // bytes of w, and of x, one stage holds at most
constexpr int kRouteSortBlocks = 256;        // the sort launch's blocks (more only past its table)
constexpr int kRoutePrefetch = 4;            // pairs a sort thread reads before the counts
constexpr int kRouteSortTable = 160 * 1024;  // bytes of the sort launch's tile bases
constexpr int kRouteCounters = 256;  // ints of the counter buffer: one a tile (groups > 1)

__host__ __device__ constexpr int64_t route_cdiv(int64_t a, int64_t b) { return (a + b - 1) / b; }

// The launch's shape, from (T, D, E, k) and the SM count alone.
//
// Product.  A thread holds tm tokens x 8 experts of one slice (tm = 8, or
// 2 while tiles of 8 would leave most SMs idle): ep = E padded to 8 nc
// (nc a power of two) splits over nc lanes, 4 + 4 experts a lane (4c ..
// 4c + 3 and ep / 2 + 4c ..), the tokens over 32 / nc lanes (row r takes
// tokens r, r + 32 / nc, ...).  Per two d a lane reads one bf16 pair of x
// per token and four float4 of w (the same for the lanes of a column: a
// broadcast), and does 16 tm FMAs.  A block is 8 compute warps: ws slice
// warps x wt token warps; the ws warps take ws slices of the same tokens
// at once, a tile is the wt x btw tokens.  The 32 slices of a tile go to
// `groups` blocks; with one group the block walks `rounds` rounds of ws
// slices and folds each round's chains in slice order into registers
// (through the fold buffer), otherwise every slice's chain meets the
// others' in the workspace.  A stage holds the ws slices' next ks values
// of d: for each slice a box of x (tt rows of ks bf16, dense) and one of w
// (ks rows of ep fp32), each on a 128-byte boundary, loaded by TMA (a
// producer warp, full and empty mbarriers a stage) where the tensors' rows
// are 16-byte multiples, else by cp.async.
struct RouteShape {
    int tm, nc, ep, btw, groups, ws, wt, tt, n_tiles, rounds, slice, stages, ks, subs, xs_words;
    int x_box, w_box, x_bytes, stage_bytes, fold_bytes, smem;
    int sort_chunk, sort_blocks, sort_smem;
    bool tma;
    int64_t part_floats, ws_bytes;
};

__host__ __device__ constexpr int route_align128(int b) { return (b + 127) & ~127; }

RouteShape route_shape(int T, int D, int E, int k, int sms) {
    RouteShape s;
    s.nc = 1;
    while (8 * s.nc < E) s.nc *= 2;
    s.ep = 8 * s.nc;
    s.slice = (((D + kRouteSlices - 1) / kRouteSlices) + 1) & ~1;
    const int rows = 32 / s.nc;
    s.tm = route_cdiv(T, rows * 8) * 4 >= sms ? 8 : 2;
    s.btw = rows * s.tm;
    // groups: the cheapest split (a block's w bytes plus the fold's workspace
    // bytes) that fits the SMs; one group for 8 tokens a thread
    s.groups = 1;
    if (s.tm == 2) {
        int64_t best = -1;
        for (int g = kRouteSlices; g >= 1; g /= 2) {
            const int ws = min(kRouteWarps, kRouteSlices / g), tt = kRouteWarps / ws * s.btw;
            const int64_t tiles = route_cdiv(T, tt);
            if (g > 1 && (tiles * g > sms || tiles >= kRouteCounters - 1)) continue;
            const int64_t cost = (int64_t)(kRouteSlices / g) * s.slice * s.ep * 4 +
                                 (g > 1 ? (int64_t)min(tt, T) * s.ep * kRouteSlices * 4 : 0);
            if (best < 0 || cost < best) {
                best = cost;
                s.groups = g;
            }
        }
    }
    s.ws = min(kRouteWarps, kRouteSlices / s.groups);
    s.wt = kRouteWarps / s.ws;
    s.tt = s.wt * s.btw;
    s.n_tiles = (int)route_cdiv(T, s.tt);
    s.rounds = kRouteSlices / s.groups / s.ws;
    // 8 tokens a thread: two stages of twice the d (half the stage handovers)
    s.stages = s.tm == 8 ? 2 : kRouteStages;
    const int cap = s.tm == 8 ? 2 * kRouteStageCap : kRouteStageCap;
    const int ks = min(s.slice, min(cap / (s.ws * s.ep * 4), cap / (s.ws * s.tt * 2)));
    s.ks = ks >= 8 ? ks & ~7 : max(2, ks & ~1);
    s.subs = (int)route_cdiv(s.slice, s.ks);
    s.xs_words = s.ks / 2;
    s.x_box = route_align128(s.tt * s.ks * 2);
    s.w_box = route_align128(s.ks * s.ep * 4);
    s.x_bytes = s.ws * s.x_box;
    s.stage_bytes = s.x_bytes + s.ws * s.w_box;
    s.fold_bytes = s.groups == 1 ? s.ws * s.tt * s.ep * 4 : 0;
    s.tma = D % 8 == 0 && E % 4 == 0 && s.ks % 8 == 0 && s.tt <= 256;
    // after the products: the logits (tt, ep + 1), each token's k experts,
    // weights and ranks, and the rank's counts (8 warps, E)
    const int route_bytes = (s.tt * (s.ep + 1) + 3 * s.tt * k + kRouteWarps * E) * 4;
    s.smem = 128 + max(s.stages * s.stage_bytes + s.fold_bytes, route_bytes);
    s.part_floats = s.groups > 1 ? (int64_t)kRouteSlices * s.n_tiles * s.tt * s.ep : 0;
    s.ws_bytes = s.part_floats * 4 + (int64_t)s.n_tiles * E * 4;
    s.sort_chunk = (int)max((int64_t)1, min(route_cdiv(s.n_tiles, kRouteSortBlocks),
                                            (int64_t)kRouteSortTable / (E * 4)));
    s.sort_blocks = s.n_tiles > 1 ? (int)route_cdiv(s.n_tiles, s.sort_chunk) : 0;
    s.sort_smem = s.sort_chunk * E * 4;
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
    bool tma;                    // the stages loaded by TMA (s.tma and 16-byte aligned tensors)
    RouteShape s;
    CUtensorMap xmap;            // x (T, D) bf16, box (ks, tt)
    CUtensorMap wmap;            // w (D, E) fp32, box (ep, ks)
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

// Until every group but the ring's newest stages - 1 is complete.
__device__ __forceinline__ void cp_async_wait_ring(int stages) {
    if (stages == 2) asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    else asm volatile("cp.async.wait_group 2;\n" ::: "memory");
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

// The routing launch's compute threads' barrier (the producer warp has
// left by the time the others use it).
__device__ __forceinline__ void route_sync() { named_bar_sync(1, kRouteThreads); }

// True in every compute thread of the one block that arrives last at
// `counter` (of `n`), which also sets it back to 0 for the next launch.
// Every block's global writes before the call are visible to that block
// after it.
__device__ bool last_to_arrive(int* counter, int n, int* flag) {
    __threadfence();
    route_sync();
    if (threadIdx.x == 0) {
        const bool last = atomicAdd(counter, 1) == n - 1;
        if (last) atomicExch(counter, 0);
        *flag = last;
    }
    route_sync();
    if (!*flag) return false;
    __threadfence();
    return true;
}

// The d extent of slice sl: [d0, d0 + len).
__device__ __forceinline__ int2 route_slice(const RouteParams& p, int sl) {
    const int d0 = min(p.D, sl * p.s.slice);
    return make_int2(d0, min(p.D, d0 + p.s.slice) - d0);
}

// Stage i of the block (round i / subs, sub-stage i % subs): for each slice
// warp j, slice s_lo + round ws + j, its d values [u ks, u ks + ks) from the
// slice's start: x rows t0 .. t0 + tt (bf16 pairs at a stride of ks / 2
// words) and w rows (ep fp32 each).  By cp.async (rows past T read row T -
// 1, experts past E are left as they are): one group.
__device__ __forceinline__ void route_stage(const RouteParams& p, int t0, int s_lo, int i,
                                            unsigned char* stage) {
    const RouteShape& s = p.s;
    const int rnd = i / s.subs, a = (i - rnd * s.subs) * s.ks;
    for (int j = 0; j < s.ws; ++j) {
        const int2 sl = route_slice(p, s_lo + rnd * s.ws + j);
        const int n = min(s.ks, sl.y - a);
        if (n <= 0) continue;
        const unsigned char* xs =
            reinterpret_cast<const unsigned char*>(p.x + (int64_t)t0 * p.D + sl.x + a);
        stage_rows<4>(stage + j * s.x_box, s.xs_words * 4, xs, (int64_t)p.D * 2, s.tt,
                      p.T - 1 - t0, n / 2);
        const unsigned char* ws =
            reinterpret_cast<const unsigned char*>(p.w + (int64_t)(sl.x + a) * p.E);
        unsigned char* wd = stage + s.x_bytes + j * s.w_box;
        if (p.w_vec)
            stage_rows<16>(wd, s.ep * 4, ws, (int64_t)p.E * 4, n, n - 1, p.E / 4);
        else
            stage_rows<4>(wd, s.ep * 4, ws, (int64_t)p.E * 4, n, n - 1, p.E);
    }
    cp_async_commit_group();
}

// The same stage by TMA, issued by one warp (a box a lane), completing on
// `bar`: a box of x (rows past T and d past D read as zero) and one of w
// (experts past E zero) a slice.
__device__ __forceinline__ void route_stage_tma(const RouteParams& p, int t0, int s_lo, int i,
                                                unsigned char* stage, uint64_t* bar) {
    const RouteShape& s = p.s;
    const int rnd = i / s.subs, a = (i - rnd * s.subs) * s.ks, lane = threadIdx.x & 31;
    if (lane == 0) {
        uint32_t bytes = 0;
        for (int j = 0; j < s.ws; ++j)
            if (route_slice(p, s_lo + rnd * s.ws + j).y > a)
                bytes += s.tt * s.ks * 2 + s.ks * s.ep * 4;
        mbar_arrive_expect_tx(bar, bytes);
    }
    __syncwarp();
    if (lane < 2 * s.ws) {
        const int j = lane % s.ws;
        const int2 sl = route_slice(p, s_lo + rnd * s.ws + j);
        if (sl.y > a) {
            if (lane < s.ws) tma_load_2d(stage + j * s.x_box, &p.xmap, bar, sl.x + a, t0);
            else tma_load_2d(stage + s.x_bytes + j * s.w_box, &p.wmap, bar, 0, sl.x + a);
        }
    }
}

__device__ __forceinline__ float4 lds4(const float* q) {
    float4 v;
    asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
                 : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
                 : "r"(smem_u32(q)));
    return v;
}

__device__ __forceinline__ void fma4(float* acc, float x, const float4& w) {
    acc[0] = fmaf(x, w.x, acc[0]);
    acc[1] = fmaf(x, w.y, acc[1]);
    acc[2] = fmaf(x, w.z, acc[2]);
    acc[3] = fmaf(x, w.w, acc[3]);
}

// n values of d (even) of one staged slice into the warp's chains: lane
// (r, c) holds tokens tok0 + r + rows i (i < TM) x experts 4c .. 4c + 3 and
// ep / 2 + 4c ..; each chain in d order.  EPC: ep known at compile time (64),
// or 0.
template <int TM, int EPC>
__device__ __forceinline__ void route_chain(const RouteShape& s, const unsigned char* stage, int j,
                                            int tok0, int lane, int n, float (&acc)[TM][8]) {
    const int ep = EPC ? EPC : s.ep, nc = ep / 8, xw = EPC ? s.ks / 2 : s.xs_words;
    const int c = lane & (nc - 1), r = lane / nc, rows = 32 / nc;
    const uint32_t* xs = reinterpret_cast<const uint32_t*>(stage + j * s.x_box) + (tok0 + r) * xw;
    const float* ws = reinterpret_cast<const float*>(stage + s.x_bytes + j * s.w_box) + 4 * c;
    const int ehalf = ep / 2, xstep = rows * xw;
#pragma unroll 2
    for (int d = 0; d < n; d += 2) {
        float2 xv[TM];
#pragma unroll
        for (int i = 0; i < TM; ++i)
            xv[i] = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(xs + i * xstep +
                                                                                 d / 2));
        const float4 a0 = lds4(ws + d * ep);
        const float4 b0 = lds4(ws + d * ep + ehalf);
        const float4 a1 = lds4(ws + (d + 1) * ep);
        const float4 b1 = lds4(ws + (d + 1) * ep + ehalf);
#pragma unroll
        for (int i = 0; i < TM; ++i) {
            fma4(acc[i], xv[i].x, a0);
            fma4(acc[i] + 4, xv[i].x, b0);
            fma4(acc[i], xv[i].y, a1);
            fma4(acc[i] + 4, xv[i].y, b1);
        }
    }
}

// Pair q's place in the sort: its sorted row `at` and its rank r within its expert.
__device__ __forceinline__ void route_place(const RouteParams& p, int64_t q, int r, int at) {
    p.pos[q] = at;
    p.rank[q] = r;
    p.order[at] = (int)q;
    p.tok[at] = (int)(q / p.k);
}

// Offsets: an exclusive scan of cnt (E totals) over the experts by warp 0,
// into cnt and (write_out) p.offsets.
__device__ void route_offsets(const RouteParams& p, int* cnt, bool write_out) {
    const int lane = threadIdx.x;
    if (threadIdx.x >= 32) return;
    int carry = 0;
    for (int e0 = 0; e0 < p.E; e0 += 32) {
        const int e = e0 + lane;
        const int c = e < p.E ? cnt[e] : 0;
        int incl = c;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
            const int n = __shfl_up_sync(0xffffffffu, incl, o);
            if (lane >= o) incl += n;
        }
        if (e < p.E) {
            cnt[e] = carry + incl - c;
            if (write_out) p.offsets[e] = carry + incl - c;
        }
        carry += __shfl_sync(0xffffffffu, incl, 31);
    }
    if (lane == 0 && write_out) p.offsets[p.E] = carry;
}

// The stable counting sort of tiles [j0, j1) of a routing launch with more
// than one tile, by the 8 compute warps of a block (route_sync): each
// expert's total and each tile's base within its expert (the counts of the
// tiles before it) come from `hist` in one pass (4 experts a load where E %
// 4 == 0; the range's own rows kept in `bases`, (j1 - j0, E) ints), summed
// in integers; the offsets are the totals' scan; each pair's sorted row is
// offsets[e] + its tile's base + its rank within the tile.  The first
// kRoutePrefetch pairs a thread places are read before the pass.  red
// holds 8 kRouteThreads ints, offs kRouteMaxE.
__device__ void route_sort_tiles(const RouteParams& p, int j0, int j1, int* bases, int* red,
                                 int* offs, bool write_offsets) {
    const RouteShape& s = p.s;
    const int tid = threadIdx.x, E = p.E, k = p.k;
    int* red_b = red;
    int* red_t = red + 4 * kRouteThreads;
    const int64_t q0 = (int64_t)j0 * s.tt * k, q1 = (int64_t)min(p.T, j1 * s.tt) * k;
    int pe[kRoutePrefetch], pr[kRoutePrefetch];
#pragma unroll
    for (int i = 0; i < kRoutePrefetch; ++i) {
        const int64_t q = q0 + tid + (int64_t)kRouteThreads * i;
        pe[i] = q < q1 ? __ldcg(p.idx + q) : 0;
        pr[i] = q < q1 ? __ldcg(p.rank + q) : 0;
    }
    const int vec = E % 4 == 0 ? 4 : 1, nv = E / vec, parts = kRouteThreads / nv;
    const int ev = tid % nv, part = tid / nv;
    int below[4] = {0, 0, 0, 0}, total[4] = {0, 0, 0, 0};
    if (part < parts) {
#pragma unroll 8
        for (int j = part; j < s.n_tiles; j += parts) {
            const int* h = p.hist + (int64_t)j * E + vec * ev;
            int hv[4] = {0, 0, 0, 0};
            if (vec == 4) {
                const int4 q = __ldcg(reinterpret_cast<const int4*>(h));
                hv[0] = q.x;
                hv[1] = q.y;
                hv[2] = q.z;
                hv[3] = q.w;
            } else {
                hv[0] = __ldcg(h);
            }
            const bool mine = j >= j0 && j < j1;
#pragma unroll
            for (int q = 0; q < 4; ++q) {
                if (q >= vec) break;
                total[q] += hv[q];
                below[q] += j < j0 ? hv[q] : 0;
                if (mine) bases[(j - j0) * E + vec * ev + q] = hv[q];
            }
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) {
            if (q >= vec) break;
            red_b[part * E + vec * ev + q] = below[q];
            red_t[part * E + vec * ev + q] = total[q];
        }
    }
    route_sync();
    if (tid < E) {
        int b = 0, t = 0;
        for (int q = 0; q < parts; ++q) {
            b += red_b[q * E + tid];
            t += red_t[q * E + tid];
        }
        offs[tid] = t;
        for (int j = 0; j < j1 - j0; ++j) {
            const int h = bases[j * E + tid];
            bases[j * E + tid] = b;
            b += h;
        }
    }
    route_sync();
    route_offsets(p, offs, write_offsets);
    route_sync();
    const int tk = s.tt * k;
#pragma unroll
    for (int i = 0; i < kRoutePrefetch; ++i) {
        const int64_t q = q0 + tid + (int64_t)kRouteThreads * i;
        if (q < q1) {
            const int r = bases[(int)((q - q0) / tk) * E + pe[i]] + pr[i];
            route_place(p, q, r, offs[pe[i]] + r);
        }
    }
#pragma unroll 4
    for (int64_t q = q0 + tid + (int64_t)kRouteThreads * kRoutePrefetch; q < q1;
         q += kRouteThreads) {
        const int ex = __ldcg(p.idx + q), rr = __ldcg(p.rank + q);
        const int r = bases[(int)((q - q0) / tk) * E + ex] + rr;
        route_place(p, q, r, offs[ex] + r);
    }
}

// Softmax, top-k (or the forced experts) and the renormalised weights of
// the tile's tokens, a warp a token, B tokens of a warp at once (tokens
// warp, warp + 8, ...): lane l holds experts l + 32 c (c < EC).  The max
// and the softmax's sum are xor reductions over the warp, the sum each
// lane's experts in c order from 0 (the earlier router kernel's order, so
// the gates stay bitwise).  The top-k takes k rounds of a warp argmax over
// the experts not yet taken, ties to the lower expert (jax.lax.top_k's
// order), and sums the chosen gates in round order.  lg (rows of lgs)
// holds the logits and takes the gates; topi, topv (tt, k) take the
// experts and weights.  Writes the logits and gates out.
template <int EC, int B>
__device__ void route_tokens(const RouteParams& p, int t0, int n_valid, float* lg, int lgs,
                             int* topi, float* topv) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, E = p.E, k = p.k;
    for (int b0 = warp; b0 < n_valid; b0 += B * kRouteWarps) {
        int t[B];
        bool ok[B];
        float v[B][EC], m[B], sum[B];
#pragma unroll
        for (int q = 0; q < B; ++q) {
            t[q] = b0 + kRouteWarps * q;
            ok[q] = t[q] < n_valid;
            t[q] = ok[q] ? t[q] : b0;
            m[q] = -INFINITY;
#pragma unroll
            for (int c = 0; c < EC; ++c) {
                const int e = lane + 32 * c;
                v[q][c] = e < E ? lg[t[q] * lgs + e] : -INFINITY;
                m[q] = fmaxf(m[q], v[q][c]);
            }
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
#pragma unroll
            for (int q = 0; q < B; ++q) m[q] = fmaxf(m[q], __shfl_xor_sync(0xffffffffu, m[q], o));
#pragma unroll
        for (int q = 0; q < B; ++q) {
            sum[q] = 0.f;
#pragma unroll
            for (int c = 0; c < EC; ++c) {
                const int e = lane + 32 * c;
                const float ex = e < E ? expf(v[q][c] - m[q]) : 0.f;
                if (ok[q] && e < E) p.logits[(int64_t)(t0 + t[q]) * E + e] = v[q][c];
                v[q][c] = ex;
                sum[q] += ex;
            }
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
#pragma unroll
            for (int q = 0; q < B; ++q) sum[q] += __shfl_xor_sync(0xffffffffu, sum[q], o);
        unsigned taken[B];
#pragma unroll
        for (int q = 0; q < B; ++q) {
            taken[q] = 0u;
#pragma unroll
            for (int c = 0; c < EC; ++c) {
                const int e = lane + 32 * c;
                v[q][c] = v[q][c] / sum[q];
                if (ok[q] && e < E) {
                    p.gates[(int64_t)(t0 + t[q]) * E + e] = v[q][c];
                    lg[t[q] * lgs + e] = v[q][c];
                }
            }
        }
        float my_w[B] = {}, wsum[B] = {};
        int my_i[B] = {};
        if (p.forced != nullptr) {
            __syncwarp();
#pragma unroll
            for (int q = 0; q < B; ++q) {
                my_i[q] = lane < k ? min(max(p.forced[(int64_t)(t0 + t[q]) * k + lane], 0), E - 1)
                                   : 0;
                my_w[q] = lane < k ? lg[t[q] * lgs + my_i[q]] : 0.f;
            }
            for (int j = 0; j < k; ++j)
#pragma unroll
                for (int q = 0; q < B; ++q) {
                    const float wj = __shfl_sync(0xffffffffu, my_w[q], j);
                    wsum[q] = j == 0 ? wj : __fadd_rn(wsum[q], wj);
                }
        } else {
            for (int j = 0; j < k; ++j) {
                float bv[B];
                int bi[B];
#pragma unroll
                for (int q = 0; q < B; ++q) {
                    bv[q] = -INFINITY;
                    bi[q] = E;
#pragma unroll
                    for (int c = 0; c < EC; ++c) {
                        const int e = lane + 32 * c;
                        if (e < E && !((taken[q] >> c) & 1u) && v[q][c] > bv[q]) {
                            bv[q] = v[q][c];
                            bi[q] = e;
                        }
                    }
                }
#pragma unroll
                for (int o = 16; o > 0; o >>= 1)
#pragma unroll
                    for (int q = 0; q < B; ++q) {
                        const float ov = __shfl_xor_sync(0xffffffffu, bv[q], o);
                        const int oi = __shfl_xor_sync(0xffffffffu, bi[q], o);
                        if (ov > bv[q] || (ov == bv[q] && oi < bi[q])) {
                            bv[q] = ov;
                            bi[q] = oi;
                        }
                    }
#pragma unroll
                for (int q = 0; q < B; ++q) {
                    if (bi[q] >= E) {       // no gate left to take (NaN gates): expert 0
                        bi[q] = 0;
                        bv[q] = __shfl_sync(0xffffffffu, v[q][0], 0);
                    } else if ((bi[q] & 31) == lane) {
                        taken[q] |= 1u << (bi[q] >> 5);
                    }
                    if (lane == j) {
                        my_i[q] = bi[q];
                        my_w[q] = bv[q];
                    }
                    wsum[q] = j == 0 ? bv[q] : __fadd_rn(wsum[q], bv[q]);
                }
            }
        }
        // the k weights divided by max(their sum in order j, 1e-9)
#pragma unroll
        for (int q = 0; q < B; ++q) {
            const float den = wsum[q] < 1e-9f ? 1e-9f : wsum[q];
            if (ok[q] && lane < k) {
                topi[t[q] * k + lane] = my_i[q];
                topv[t[q] * k + lane] = __fdiv_rn(my_w[q], den);
            }
        }
        __syncwarp();
    }
}

// One launch of the layer's routing: grid (n_tiles, groups), 8 compute warps
// and a producer warp.  Each block takes its group's slices of one tile of
// tokens through a three-stage ring (TMA from the producer warp, full and
// empty mbarriers; else cp.async by the compute warps), register-tiled
// (route_chain); the slice sums are added in slice order, through shared
// memory (one group) or, from the workspace, by the last of the tile's
// blocks.  That block routes its tile (route_tokens) and warp 0 ranks the
// tile's pairs within their experts in pair order (__match_any_sync, 32 at
// a time).  With one tile the block sorts the pairs; otherwise it leaves
// its counts in `hist` for the sort launch.
template <int TM, int EPC>
__global__ void __launch_bounds__(kRouteBlock)
moe_route_kernel(const __grid_constant__ RouteParams p) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    __shared__ int cnt[kRouteMaxE];
    __shared__ int flag;
    __shared__ __align__(8) uint64_t full[kRouteStages], empty[kRouteStages];
    unsigned char* smem = reinterpret_cast<unsigned char*>(
        (reinterpret_cast<uintptr_t>(smem_raw) + 127) & ~uintptr_t(127));
    const RouteShape& s = p.s;
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int tile = blockIdx.x, t0 = tile * s.tt, E = p.E, k = p.k;
    const int n_valid = min(s.tt, p.T - t0);
    const int s_lo = blockIdx.y * (kRouteSlices / s.groups);
    const int n_stages = s.rounds * s.subs;
    if (tid == 0) {
        for (int i = 0; i < s.stages; ++i) {
            mbar_init(&full[i], 1);
            mbar_init(&empty[i], kRouteWarps);
        }
        mbar_fence_init();
    }
    __syncthreads();
    if (warp == kRouteWarps) {          // the producer warp: TMA stages, then done
        if (p.tma) {
            for (int i = 0; i < n_stages; ++i) {
                const int slot = i % s.stages;
                if (i >= s.stages) mbar_wait(&empty[slot], ((i / s.stages) - 1) & 1);
                route_stage_tma(p, t0, s_lo, i, smem + slot * s.stage_bytes, &full[slot]);
            }
        }
        return;
    }
    const int wj = warp % s.ws, tok0 = (warp / s.ws) * s.btw;
    const bool active = tok0 < n_valid;              // warp-uniform
    const int c = lane & (s.nc - 1), r = lane / s.nc, rows = 32 / s.nc, ehalf = s.ep / 2;
    float* fold = reinterpret_cast<float*>(smem + s.stages * s.stage_bytes);
    const int64_t n_rows = (int64_t)s.n_tiles * s.tt;

    float run[TM];              // one group: tt ep = 256 TM outputs, TM a thread, folded in order
    float acc[TM][8];
    if (!p.tma) {
        for (int i = 0; i < s.stages - 1; ++i) {
            if (i < n_stages) route_stage(p, t0, s_lo, i, smem + i * s.stage_bytes);
            else cp_async_commit_group();
        }
    }
    for (int i = 0; i < n_stages; ++i) {
        const int slot = i % s.stages;
        if (p.tma) {
            mbar_wait(&full[slot], (i / s.stages) & 1);
        } else {
            const int ahead = i + s.stages - 1;
            if (ahead < n_stages)
                route_stage(p, t0, s_lo, ahead, smem + (ahead % s.stages) * s.stage_bytes);
            else
                cp_async_commit_group();
            cp_async_wait_ring(s.stages);
            route_sync();
        }
        const int rnd = i / s.subs, u = i - rnd * s.subs;
        const int sl = s_lo + rnd * s.ws + wj;
        const int n = min(s.ks, route_slice(p, sl).y - u * s.ks);
        if (u == 0) {
#pragma unroll
            for (int a = 0; a < TM; ++a)
#pragma unroll
                for (int b = 0; b < 8; ++b) acc[a][b] = 0.f;
        }
        if (active && n > 0)
            route_chain<TM, EPC>(s, smem + slot * s.stage_bytes, wj, tok0, lane, n, acc);
        if (p.tma) {                                 // the stage may be refilled
            __syncwarp();
            mbar_arrive_if(&empty[slot], lane == 0);
        } else {
            route_sync();
        }
        if (u != s.subs - 1) continue;
        if (s.groups == 1) {                         // the round's chains, folded in slice order
            route_sync();                            // the last round's fold reads are done
#pragma unroll
            for (int a = 0; a < TM; ++a) {
                float* dst = fold + ((wj * s.tt) + tok0 + r + rows * a) * s.ep + 4 * c;
                *reinterpret_cast<float4*>(dst) = make_float4(acc[a][0], acc[a][1], acc[a][2],
                                                              acc[a][3]);
                *reinterpret_cast<float4*>(dst + ehalf) =
                    make_float4(acc[a][4], acc[a][5], acc[a][6], acc[a][7]);
            }
            route_sync();
#pragma unroll
            for (int m = 0; m < TM; ++m) {
#pragma unroll
                for (int j = 0; j < kRouteWarps; ++j) {
                    const float v = fold[j * s.tt * s.ep + tid + kRouteThreads * m];
                    run[m] = rnd == 0 && j == 0 ? v : __fadd_rn(run[m], v);
                }
            }
        } else if (active) {                         // the slice's chains into the workspace
#pragma unroll
            for (int a = 0; a < TM; ++a) {
                const int t = tok0 + r + rows * a;
                if (t >= n_valid) continue;
                float* dst = p.part + ((int64_t)sl * n_rows + t0 + t) * s.ep + 4 * c;
                *reinterpret_cast<float4*>(dst) = make_float4(acc[a][0], acc[a][1], acc[a][2],
                                                              acc[a][3]);
                *reinterpret_cast<float4*>(dst + ehalf) =
                    make_float4(acc[a][4], acc[a][5], acc[a][6], acc[a][7]);
            }
        }
    }

    // the tile's logits, (tt, ep + 1), over the ring
    const int lgs = s.ep + 1;
    float* lg = reinterpret_cast<float*>(smem);
    int* topi = reinterpret_cast<int*>(lg + s.tt * lgs);     // (tt, k): the tile's pairs' experts
    float* topv = reinterpret_cast<float*>(topi + s.tt * k);
    int* rk = reinterpret_cast<int*>(topv + s.tt * k);
    route_sync();               // every warp is done with the ring and the fold buffer
    if (s.groups == 1) {
#pragma unroll
        for (int m = 0; m < TM; ++m) {
            const int o = tid + kRouteThreads * m, t = o / s.ep;
            lg[t * lgs + o - t * s.ep] = run[m];
        }
    } else {
        if (!last_to_arrive(p.counters + tile, s.groups, &flag)) return;
        const int64_t stride = n_rows * s.ep;
        if (E % 4 == 0) {
            const int e4 = E / 4;
            for (int i = tid; i < n_valid * e4; i += kRouteThreads) {
                const int t = i / e4, e = 4 * (i - t * e4);
                const float* src = p.part + (int64_t)(t0 + t) * s.ep + e;
                float4 v[kRouteSlices];
#pragma unroll
                for (int q = 0; q < kRouteSlices; ++q)
                    v[q] = __ldcg(reinterpret_cast<const float4*>(src + q * stride));
                float4 sum = v[0];
#pragma unroll
                for (int q = 1; q < kRouteSlices; ++q) {
                    sum.x = __fadd_rn(sum.x, v[q].x);
                    sum.y = __fadd_rn(sum.y, v[q].y);
                    sum.z = __fadd_rn(sum.z, v[q].z);
                    sum.w = __fadd_rn(sum.w, v[q].w);
                }
                float* dst = lg + t * lgs + e;
                dst[0] = sum.x;
                dst[1] = sum.y;
                dst[2] = sum.z;
                dst[3] = sum.w;
            }
        } else {
            for (int i = tid; i < n_valid * E; i += kRouteThreads) {
                const int t = i / E, e = i - t * E;
                const float* src = p.part + (int64_t)(t0 + t) * s.ep + e;
                float sum = __ldcg(src);
#pragma unroll
                for (int q = 1; q < kRouteSlices; ++q)
                    sum = __fadd_rn(sum, __ldcg(src + q * stride));
                lg[t * lgs + e] = sum;
            }
        }
    }
    route_sync();
    // B tokens of a warp at once: 4 where every warp has 4 or more, 2 where 2
    const int per_warp = (n_valid + kRouteWarps - 1) / kRouteWarps;
    if (E <= 32) {
        if (per_warp >= 4) route_tokens<1, 4>(p, t0, n_valid, lg, lgs, topi, topv);
        else if (per_warp >= 2) route_tokens<1, 2>(p, t0, n_valid, lg, lgs, topi, topv);
        else route_tokens<1, 1>(p, t0, n_valid, lg, lgs, topi, topv);
    } else if (E <= 64) {
        if (per_warp >= 4) route_tokens<2, 4>(p, t0, n_valid, lg, lgs, topi, topv);
        else if (per_warp >= 2) route_tokens<2, 2>(p, t0, n_valid, lg, lgs, topi, topv);
        else route_tokens<2, 1>(p, t0, n_valid, lg, lgs, topi, topv);
    } else {
        if (per_warp >= 4) route_tokens<4, 4>(p, t0, n_valid, lg, lgs, topi, topv);
        else if (per_warp >= 2) route_tokens<4, 2>(p, t0, n_valid, lg, lgs, topi, topv);
        else route_tokens<4, 1>(p, t0, n_valid, lg, lgs, topi, topv);
    }
    // each pair's rank within its expert in the tile, in pair order: warp w
    // ranks the w-th eighth of the pairs (__match_any_sync, 32 at a time)
    // into its counts cw[w], whose prefix over the warps is each eighth's base
    int* cw = rk + s.tt * k;                         // (8 warps, E)
    for (int i = tid; i < kRouteWarps * E; i += kRouteThreads) cw[i] = 0;
    route_sync();
    const int n_pairs = n_valid * k;
    const int64_t tk = (int64_t)t0 * k;
    for (int i = tid; i < n_pairs; i += kRouteThreads) {
        p.weights[tk + i] = topv[i];
        p.idx[tk + i] = topi[i];
    }
    const int per = (n_pairs + kRouteWarps - 1) / kRouteWarps;
    const int w_lo = min(n_pairs, warp * per), w_hi = min(n_pairs, w_lo + per);
    int* mine = cw + warp * E;
    for (int b = w_lo; b < w_hi; b += 32) {
        const int q = b + lane;
        const bool ok = q < w_hi;
        const int e = ok ? topi[q] : -1 - lane;
        const unsigned mask = __match_any_sync(0xffffffffu, e);
        const int before = __popc(mask & ((1u << lane) - 1u));
        const int c0 = ok ? mine[e] : 0;
        __syncwarp();
        if (ok) {
            rk[q] = c0 + before;
            if (before == 0) mine[e] = c0 + __popc(mask);
        }
        __syncwarp();
    }
    route_sync();
    for (int e = tid; e < E; e += kRouteThreads) {
        int run_e = 0;
        for (int w = 0; w < kRouteWarps; ++w) {
            const int c = cw[w * E + e];
            cw[w * E + e] = run_e;
            run_e += c;
        }
        cnt[e] = run_e;
    }
    route_sync();
    for (int q = w_lo + lane; q < w_hi; q += 32) {
        rk[q] += cw[warp * E + topi[q]];
        if (s.n_tiles > 1) p.rank[tk + q] = rk[q];
    }
    route_sync();
    if (s.n_tiles == 1) {       // one tile: the stable counting sort here
        route_offsets(p, cnt, true);
        route_sync();
        for (int q = tid; q < n_pairs; q += kRouteThreads)
            route_place(p, q, rk[q], cnt[topi[q]] + rk[q]);
        return;
    }
    for (int e = tid; e < E; e += kRouteThreads) p.hist[(int64_t)tile * E + e] = cnt[e];
}

// The sort launch (many tiles, after moe_route_kernel): block b sorts
// tiles [b chunk, (b + 1) chunk); block 0 writes the offsets.
__global__ void __launch_bounds__(kRouteThreads)
moe_route_sort_kernel(const __grid_constant__ RouteParams p) {
    extern __shared__ __align__(16) unsigned char smem[];
    __shared__ int red[8 * kRouteThreads];
    __shared__ int offs[kRouteMaxE];
    const int j0 = blockIdx.x * p.s.sort_chunk;
    route_sort_tiles(p, j0, min(p.s.n_tiles, j0 + p.s.sort_chunk), reinterpret_cast<int*>(smem),
                     red, offs, blockIdx.x == 0);
}

// out (T, D) = bf16(sum_j bf16(ys[pos[t k + j]] * bf16(weights[t, j]))), the
// k products added in order in fp32 (a dropped pair's product is
// bf16(0 * w)), then bf16(out + y_shared): the roundings of the plain
// combine.  With PARTIAL the fp32 sum itself is stored, uncast, with no
// shared row (an expert shard's part of the routed sum, which the caller
// all-reduces over the shards before the one cast).  A thread takes 8
// columns of one token (16-byte loads, 16- or 32-byte stores).
template <bool PARTIAL>
__global__ void __launch_bounds__(128)
moe_combine_kernel(const __nv_bfloat16* __restrict__ ys, const int* __restrict__ pos,
                   const float* __restrict__ weights, const unsigned char* __restrict__ kept,
                   const __nv_bfloat16* __restrict__ y_shared, void* __restrict__ out_raw,
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
    if (PARTIAL) {
        float4* o = reinterpret_cast<float4*>(static_cast<float*>(out_raw) + (int64_t)t * D + c);
        o[0] = make_float4(acc[0], acc[1], acc[2], acc[3]);
        o[1] = make_float4(acc[4], acc[5], acc[6], acc[7]);
        return;
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
    *reinterpret_cast<uint4*>(static_cast<__nv_bfloat16*>(out_raw) + (int64_t)t * D + c) = res;
}

template <int TM, int EPC>
cudaError_t launch_route(const RouteParams& p, cudaStream_t stream) {
    cudaError_t e = cudaFuncSetAttribute(moe_route_kernel<TM, EPC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, p.s.smem);
    if (e != cudaSuccess) return e;
    moe_route_kernel<TM, EPC>
        <<<dim3(p.s.n_tiles, p.s.groups), kRouteBlock, p.s.smem, stream>>>(p);
    e = cudaGetLastError();
    if (e != cudaSuccess || p.s.n_tiles == 1) return e;
    e = cudaFuncSetAttribute(moe_route_sort_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             p.s.sort_smem);
    if (e != cudaSuccess) return e;
    moe_route_sort_kernel<<<p.s.sort_blocks, kRouteThreads, p.s.sort_smem, stream>>>(p);
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
// 2^31 - 1), out[5] tokens a thread, out[6] slice warps a block, out[7] d
// values of a slice a stage holds, out[8] blocks of the sort launch (0:
// one tile, sorted in the routing launch), out[9] 1 where the stages are
// loaded by TMA (given 16-byte aligned x and w).  T >= 1, D even and at
// most 4096, 1 <= k <= E <= 128, k <= 32.
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
    out[5] = s.tm;
    out[6] = s.ws;
    out[7] = s.ks;
    out[8] = s.sort_blocks;
    out[9] = s.tma;
    return 0;
}

// A layer's routing (see moe_route_kernel; with more than one tile a second
// launch, moe_route_sort_kernel, sorts): x (T, D) bf16 (4-byte aligned), w
// (D, E) fp32, forced (T, k) int32 or null -> logits, gates (T, E) fp32,
// weights (T, k) fp32, idx (T, k) int32, offsets (E + 1,), order, tok, pos,
// rank (T k,) int32.  workspace holds moe_route_plan's bytes (16-byte
// aligned); counters, kRouteCounters int32 zeros on the device, are left
// zero again by every launch that completes (launches sharing them must
// not overlap).
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
    if ((int64_t)T * k > 0x7fffffff || p.s.smem + kRouteMaxE * 4 + 64 > kSmemLimit ||
        p.s.sort_smem > kSmemLimit - 4 * 1024 ||
        (p.s.groups > 1 && p.s.n_tiles >= kRouteCounters - 1))
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
    p.tma = p.s.tma && !(reinterpret_cast<uintptr_t>(x) & 15) && p.w_vec;
    memset(&p.xmap, 0, sizeof(p.xmap));
    memset(&p.wmap, 0, sizeof(p.wmap));
    if (p.tma) {
        const uint64_t dx[2] = {(uint64_t)D, (uint64_t)T}, sx[1] = {(uint64_t)D * 2};
        const uint32_t bx[2] = {(uint32_t)p.s.ks, (uint32_t)p.s.tt};
        const uint64_t dw[2] = {(uint64_t)E, (uint64_t)D}, sw[1] = {(uint64_t)E * 4};
        const uint32_t bw[2] = {(uint32_t)p.s.ep, (uint32_t)p.s.ks};
        if (!encode_dense(&p.xmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, 2, dx, sx, bx) ||
            !encode_dense(&p.wmap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, w, 2, dw, sw, bw))
            return (int)cudaErrorNotSupported;
    }
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (p.s.ep == 64)
        return (int)(p.s.tm == 8 ? launch_route<8, 64>(p, st) : launch_route<2, 64>(p, st));
    return (int)(p.s.tm == 8 ? launch_route<8, 0>(p, st) : launch_route<2, 0>(p, st));
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
    moe_combine_kernel<false><<<(unsigned)blocks, 128, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const __nv_bfloat16*>(ys), static_cast<const int*>(pos),
        static_cast<const float*>(weights), static_cast<const unsigned char*>(kept),
        static_cast<const __nv_bfloat16*>(y_shared), out, T, D, k);
    return (int)cudaGetLastError();
}

// out (T, D) fp32 = the same sum before its cast, with no shared row (see
// moe_combine_kernel<true>): an expert shard's partial, the pairs of other
// shards' experts dropped through kept.  ys 16-byte aligned, out 32-byte.
int moe_combine_partial_launch(const void* ys, const void* pos, const void* weights,
                               const void* kept, void* out, int T, int D, int k, void* stream) {
    const uintptr_t mis = reinterpret_cast<uintptr_t>(ys) | reinterpret_cast<uintptr_t>(out);
    if (T < 1 || D < 8 || D % 8 || k < 1 || (mis & 15) ||
        (reinterpret_cast<uintptr_t>(out) & 31))
        return (int)cudaErrorInvalidValue;
    const int64_t blocks = ((int64_t)T * (D / 8) + 127) / 128;
    if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
    moe_combine_kernel<true><<<(unsigned)blocks, 128, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const __nv_bfloat16*>(ys), static_cast<const int*>(pos),
        static_cast<const float*>(weights), static_cast<const unsigned char*>(kept), nullptr,
        out, T, D, k);
    return (int)cudaGetLastError();
}

const char* moe_experts_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
