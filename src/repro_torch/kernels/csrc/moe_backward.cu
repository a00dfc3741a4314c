// Backward of the token-choice MoE layer for Hopper (sm_90a), bound through
// a plain C interface and loaded with ctypes
// (repro_torch/kernels/moe_experts/kernel.py).  Five kernels, seven launches
// a layer, in the order the layer's autograd Function
// (kernels/moe_experts/ops.py::MoEFFN) runs them:
//
//   1. combine backward: dys and dweights from dout (moe_combine_backward);
//   2. the down data gradient: dh = dy . W_d^T with the SwiGLU or GELU
//      backward in its epilogue, writing da and db (moe_data_grad, SwiGLU
//      or GELU epilogue);
//   3. every weight gradient of the layer in one launch: dW = A[seg]^T .
//      G[seg] per expert, and the shared expert's over its T rows
//      (moe_weight_grad);
//   4. the gate/up data gradient: dx = da . W_g^T + db . W_u^T
//      (moe_data_grad, plain epilogue, two operand pairs);
//   5. the gather's backward: the forward combine kernel of moe_experts.cu
//      with unit weights (each token's k routed rows summed in order in
//      fp32, one rounding, then the shared expert's row added);
//   6. route backward, two launches: the renormalisation's and the
//      softmax's adjoints once a token (dlogits) and dx = dlogits . w^T
//      (moe_route_backward_dx), then dw = x^T . dlogits
//      (moe_route_backward_dw), in fp32 on the CUDA cores, register-tiled
//      (a thread 8 x 8 or 8 x 4 outputs: one shared-memory load feeds 4-8
//      FMAs).
//
// No Pallas kernel stands behind these: the JAX package differentiates its
// MoE layer (src/repro/models/moe.py::moe_ffn, _dispatch_ffn) through XLA.
// They are the backward of the port's forward kernels (moe_experts.cu), at
// the forward's roundings: each product's bf16 output, the activation, the
// SwiGLU product.
//
// Contract.  Deterministic: no floating-point atomics, every sum in a fixed
// order, so two launches are bitwise equal.  Fixed-shape: every grid is
// sized from shapes and the SM count, never from the device-side offsets,
// so a launch is capturable (the tensor maps pass by value).  A segment's
// rows are found through the device-side offsets by each block; rows
// outside [offsets[e], offsets[e + 1]) never enter expert e's weight
// gradient, and a segment of no rows gives a zero gradient.  Every output
// element is one bf16 rounding of one fp32 chain of bf16 wgmma k16 steps
// in k order (the epilogues' roundings after it).
//
// Design of the grouped products: the forward's (moe_experts.cu).  A
// persistent grid of at most one block an SM walks a static list of work
// items, item i on block i mod grid; a block is one producer warpgroup,
// whose one thread keeps a ring of 64-k stages in flight with TMA
// (128-byte swizzle, zeros outside the tensors, mbarriers full and
// empty), and one consumer warpgroup per 64 output rows issuing bf16
// wgmma.m64n128k16 with both operands in shared memory into fp32
// registers; the producer streams the next item's stages while the
// consumers run an epilogue, so no item pays a prologue.
//
// The data gradient (dh = dy . W_d^T with the activation's backward; dx =
// da . W_g^T + db . W_u^T) walks the forward's item map: (expert, row tile
// of BM rows, 128 columns), group 0's experts in order, each its column
// tiles with the row tiles innermost, then the shared expert as group 1;
// each block derives it from the device-side offsets by a warp scan.  BM
// is 128 (two consumer warpgroups) where group 0's segments average 128
// rows or more, else 64.  A (dy, da, db: (rows, K)) and B (the weights as
// they lie, (E, N, K)) are both K-major; stages past the first operand
// pair's K take the second pair into the same chain.  Rows of a tile past
// its segment's end are loaded and multiplied but never stored.  The
// epilogue is off the critical path: the consumers only stage dh =
// bf16(acc) in shared memory and go on to the next item, while seven
// other warps (a warpgroup of their own and the producer's idle three)
// read dh and the item's pre-activation tiles (a, and b for SwiGLU, which
// the producer loads by TMA after the item's last stage, into a buffer of
// their own) and store da and db (or the plain sum) as whole 16-byte
// chunks, two 256-byte rows a warp instruction, up to the segment's end,
// during the next item's main loop.  The ring holds as many stages as
// shared memory allows beside those tiles, at most 8 (6 on 128-row tiles:
// 4 beside SwiGLU's tiles).  The roundings: dh = bf16(acc); SwiGLU da =
// bf16(bf16(dh b) silu'(a)), db = bf16(dh bf16(silu(a))); GELU da = bf16(dh
// gelu_tanh'(a)); plain bf16(acc).
//
// The weight gradient (dW[e] = A[seg e]^T . G[seg e], up to six jobs a
// launch) walks a static list of items (job, expert, 128 rows of M, 256
// columns of N; wgmma.m64n256k16, which reads half the B bytes a product
// that m64n128k16 reads), jobs in the order given (the shared expert's
// 8192-row jobs first), the N tiles innermost; K is the segment's rows,
// walked from its first row lo in stages of 64, in order, with no split.
// Both operands lie MN-major (a (rows, M) and b (rows, N), each contiguous
// along its columns): 64-row x 64-column TMA boxes from row lo (TMA takes
// any row), read with both transpose bits set.  TMA zero-fills only past
// the tensor, so the rows at or past hi in a segment's last stage belong
// to the next expert: the consumers clear those rows in both operands
// (each warpgroup its A box and two B boxes; whole 128-byte rows, which
// the swizzle leaves whole) and issue fence.proxy.async before any wgmma
// reads them, so a neighbour's Inf or NaN never meets a zero (0 . Inf is
// NaN).
// The epilogue writes bf16(acc) into a swizzled staging tile and one
// thread a warpgroup stores it by TMA, asynchronously, while the next
// item's main loop runs.
//
// Routes: one for every shape the wrappers accept (bf16, widths multiples
// of 8, 16-byte rows): TMA reads zeros past N and K and writes nothing
// outside the output tensor.
//
// Bound on the H100 (989 TFLOP/s dense bf16, 3.35 TB/s) at moonshot's
// training microstep (T = 8192 tokens, P = 49152 pairs, D = 2048, F =
// 1408, a shared expert of 2F): the down data gradient 378 GFLOP and 1.35
// GB (dy, W_d, a, b read, da, db written: 0.40 ms, bytes), the weight
// gradients 1134 GFLOP (1.15 ms, operations), the gate/up data gradient
// 756 GFLOP (0.76 ms, operations).  The combine backward moves ~0.44 GB
// (dout, ys, dys: 0.13 ms, bytes); the route backward does 4 T D E = 4.3
// GFLOP of fp32 (64 us at 67 TFLOP/s, operations): dx's chains over E keep
// the earlier kernel's order (e = 0 .. E - 1 from 0, one bf16 rounding),
// dw's are chains over a split's tokens, the splits added in order.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kThreads = 256;        // combine and route backward: 8 warps
constexpr int kBN = 128;             // output columns per item
constexpr int kBK = 64;              // k per ring stage: one 128-byte swizzle row
constexpr int kWgRows = 64;          // output rows per consumer warpgroup (one wgmma)
constexpr int kMaxStages = 8;
constexpr int kTallStages = 6;       // the data gradient's ring on 128-row tiles
constexpr int kSmemLimit = 227 * 1024;
constexpr int kBox = kBK * 64 * 2;   // one TMA box of 64 rows x 64 columns: 8 KiB
constexpr int kMaxExperts = 256;
constexpr int kMaxJobs = 6;
constexpr int kEpiThreads = 224;     // the data gradient's epilogue: 7 warps
constexpr int kWgBN = 256;           // the weight gradient's output columns per item

enum Epi { kEpiSwiGLU = 0, kEpiGelu = 1, kEpiPlain = 2 };

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

__device__ __forceinline__ float round_bf16(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
}

// The experts' clamped offsets and first work items of one group, by warp
// 0 (lane l a run of experts, then a warp scan): expert e's rows [offs[e],
// offs[e + 1]), its items from first[e]; first[n_exp] the group's count.
template <int BM>
__device__ void scan_items(const int* offsets, int rows, int n_exp, int nc, int* offs,
                           int* first) {
    const int lane = threadIdx.x & 31;
    auto clamp = [&](int e) { return min(max(__ldg(offsets + e), 0), rows); };
    auto items = [&](int lo, int hi) { return max(hi - lo + BM - 1, 0) / BM * nc; };
    const int per = (n_exp + 31) / 32;
    const int e0 = min(n_exp, lane * per), e1 = min(n_exp, e0 + per);
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

// Byte offset, in a tile stored as 64-column boxes of `box` bytes (rows of
// 128 bytes, 128-byte swizzle), of the bf16 pair at row r, columns 8 j +
// 2 q (+ 1).
__device__ __forceinline__ int pair_offset(int box, int r, int j, int q) {
    return (j >> 3) * box + r * 128 + (((j & 7) ^ (r & 7)) << 4) + 4 * q;
}

// -- the grouped data gradient ------------------------------------------------------

struct DGroup {
    __nv_bfloat16* out0;         // (rows, N): da, or dx
    __nv_bfloat16* out1;         // (rows, N): db (SwiGLU)
    const int* offsets;          // (n_exp + 1,) on the device, or null: one segment of `rows`
    int rows, n_exp, N, K;
    int pairs;                   // 1, or 2: a second A operand and weight in the same sum
};

struct DParams {
    CUtensorMap a0[2], a1[2];    // a group's first and second A operand: (K, rows), box (64, BM)
    CUtensorMap w0[2], w1[2];    // its weights: (K, N, n_exp), box (64, 128, 1)
    CUtensorMap pa[2], pb[2];    // its pre-activations a, b: (N, rows), box (64, BM)
    DGroup g[2];
    int stages;
};

// BM x 128 pre-activation tiles an epilogue reads: SwiGLU a and b, GELU
// a, plain none.
__host__ __device__ constexpr int pre_tiles(int epi) {
    return epi == kEpiSwiGLU ? 2 : epi == kEpiGelu ? 1 : 0;
}

// One ring stage: the A tile (BM rows x 64 k) and the weight tile (128 n x
// 64 k), both K-major.
__host__ __device__ constexpr int dg_stage_bytes(int bm) { return bm * kBK * 2 + kBN * kBK * 2; }

// The epilogue's buffer: the pre-activation tiles and the staged dh tile.
__host__ __device__ constexpr int dg_epi_bytes(int epi, int bm) {
    return (pre_tiles(epi) + 1) * bm * kBN * 2;
}

// The ring's full and empty barriers, the epilogue's four, the clamped
// offsets and the experts' first items.
__host__ __device__ constexpr int dg_table_bytes(int stages, int n_exp) {
    return (stages + 2) * 16 + 2 * (n_exp + 1) * 4;
}

__host__ __device__ constexpr int dg_smem_bytes(int epi, int bm, int stages, int n_exp) {
    return 1024 + stages * dg_stage_bytes(bm) + dg_epi_bytes(epi, bm) +
           dg_table_bytes(stages, n_exp);
}

struct Item {
    int group, e, r0, r1, n0;
};

// Work item i: group 0's experts in order, each its column tiles with the
// row tiles innermost, then group 1's the same way (the forward's map,
// moe_experts.cu::item_of).  `cursor` walks the experts forward, as a
// block's items only grow.  kernels/moe_experts/backward_plan.py mirrors it.
template <int BM>
__device__ __forceinline__ Item dg_item(int i, const DParams& p, const int* offs,
                                        const int* first, int& cursor) {
    Item it;
    const int n_exp = p.g[0].n_exp;
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
        const int rt = (p.g[1].rows + BM - 1) / BM, j = i - first[n_exp];
        const int c = j / rt;
        it.group = 1;
        it.e = 0;
        it.r0 = (j - c * rt) * BM;
        it.r1 = min(it.r0 + BM, p.g[1].rows);
        it.n0 = c * kBN;
    }
    return it;
}

// gelu_tanh'(x), as PyTorch's GELU backward (tanh approximation) computes it
__device__ __forceinline__ float gelu_tanh_grad(float x) {
    const float kBeta = 0.7978845608028654f;     // sqrt(2 / pi)
    const float kKappa = 0.044715f;
    const float x_sq = x * x;
    const float inner = kBeta * (x + kKappa * x_sq * x);
    const float th = tanhf(inner);
    const float left = 0.5f * x, right = 1.f + th;
    return 0.5f * right + left * (1.f - th * th) * kBeta * (1.f + 3.f * kKappa * x_sq);
}

// The epilogue of one 8-column chunk: dh (8 bf16, bf16(acc) already), a
// and b (the forward's pre-activations) -> out0 (da, or the plain sum) and
// out1 (db), with the forward's roundings.
template <int EPI>
__device__ __forceinline__ void epilogue_chunk(const uint4& hv, const uint4& av, const uint4& bv,
                                               uint4& o0, uint4& o1) {
    const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&hv);
    const __nv_bfloat162* a2 = reinterpret_cast<const __nv_bfloat162*>(&av);
    const __nv_bfloat162* b2 = reinterpret_cast<const __nv_bfloat162*>(&bv);
    __nv_bfloat162* d0 = reinterpret_cast<__nv_bfloat162*>(&o0);
    __nv_bfloat162* d1 = reinterpret_cast<__nv_bfloat162*>(&o1);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const float2 dh = __bfloat1622float2(h2[i]), a = __bfloat1622float2(a2[i]);
        const float dhv[2] = {dh.x, dh.y}, av2[2] = {a.x, a.y};
        float da[2], db[2] = {0.f, 0.f};
        if (EPI == kEpiSwiGLU) {
            const float2 b = __bfloat1622float2(b2[i]);
            const float bv2[2] = {b.x, b.y};
#pragma unroll
            for (int q = 0; q < 2; ++q) {
                const float sg = 1.f / (1.f + expf(-av2[q]));
                const float silu = round_bf16(av2[q] / (1.f + expf(-av2[q])));
                const float dg = round_bf16(dhv[q] * bv2[q]);
                da[q] = dg * (sg * (1.f + av2[q] * (1.f - sg)));
                db[q] = dhv[q] * silu;
            }
            d1[i] = __floats2bfloat162_rn(db[0], db[1]);
        } else {
#pragma unroll
            for (int q = 0; q < 2; ++q) da[q] = dhv[q] * gelu_tanh_grad(av2[q]);
        }
        d0[i] = __floats2bfloat162_rn(da[0], da[1]);
    }
}

// Warpgroups: NWG consumers, the producer (one thread of its warp 0 issues
// every TMA load; its warps 1-3 help the epilogue), the epilogue.  Dynamic
// shared memory: the ring (1024-byte aligned stages), the epilogue's
// buffer (the pre-activation tiles, then the staged dh tile; each two
// 64-column boxes of BM rows), then the table.
template <int EPI, int NWG>
__global__ void __launch_bounds__(128 * (NWG + 2), 1)
moe_data_grad_kernel(const __grid_constant__ DParams p) {
    constexpr int BM = kWgRows * NWG;
    constexpr int kABytes = BM * kBK * 2;
    constexpr int kStage = dg_stage_bytes(BM);
    constexpr int kHalf = BM * 128;              // one 64-column box of a BM x 128 tile
    constexpr int kTile = 2 * kHalf;
    extern __shared__ unsigned char smem_raw[];
    unsigned char* ring = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
    const int S = p.stages;
    unsigned char* pre = ring + S * kStage;      // a (and b): pre_tiles(EPI) tiles
    unsigned char* dh = pre + pre_tiles(EPI) * kTile;
    uint64_t* full = reinterpret_cast<uint64_t*>(dh + kTile);
    uint64_t* empty = full + S;
    uint64_t* pre_full = empty + S;              // the pre-activation tiles landed
    uint64_t* pre_empty = pre_full + 1;          // ... and were read
    uint64_t* dh_full = pre_empty + 1;           // the consumers staged dh
    uint64_t* dh_empty = dh_full + 1;            // ... and the epilogue read it
    int* offs = reinterpret_cast<int*>(dh_empty + 1);
    const int n_exp = p.g[0].n_exp;
    int* first = offs + n_exp + 1;

    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    if (threadIdx.x == 0) {
        for (int s = 0; s < S; ++s) {
            mbar_init(&full[s], 1);
            mbar_init(&empty[s], 4 * NWG);       // lane 0 of every consumer warp
        }
        mbar_init(pre_full, 1);
        mbar_init(pre_empty, kEpiThreads);       // every epilogue thread
        mbar_init(dh_full, 128 * NWG);           // every consumer thread
        mbar_init(dh_empty, kEpiThreads);
        mbar_fence_init();
    }
    if (warp == 0)
        scan_items<BM>(p.g[0].offsets, p.g[0].rows, n_exp, cdiv(p.g[0].N, kBN), offs, first);
    __syncthreads();

    const int n_items = first[n_exp] + cdiv(p.g[1].rows, BM) * cdiv(p.g[1].N, kBN);
    const int wg = threadIdx.x >> 7, t = threadIdx.x & 127;
    int cursor = 0;
    if (wg == NWG && t == 0) {
        // producer: one thread keeps the ring full across items; after an
        // item's last stage it loads the item's pre-activation tiles, once
        // the epilogue has read the last item's (it had that item's main
        // loop to do it)
        int s = 0;
        uint32_t phase = 0, pre_phase = 0;
        for (int i = blockIdx.x; i < n_items; i += gridDim.x) {
            const Item it = dg_item<BM>(i, p, offs, first, cursor);
            const int gi = it.group;
            const int nk = cdiv(p.g[gi].K, kBK), steps = p.g[gi].pairs * nk;
            for (int kt = 0; kt < steps; ++kt) {
                mbar_wait(&empty[s], phase ^ 1);
                unsigned char* st = ring + s * kStage;
                mbar_arrive_expect_tx(&full[s], kStage);
                const bool second = kt >= nk;
                const int k0 = (second ? kt - nk : kt) * kBK;
                tma_load_2d(st, second ? &p.a1[gi] : &p.a0[gi], &full[s], k0, it.r0);
                tma_load_3d(st + kABytes, second ? &p.w1[gi] : &p.w0[gi], &full[s], k0, it.n0,
                            it.e);
                if (++s == S) {
                    s = 0;
                    phase ^= 1;
                }
            }
            if (EPI != kEpiPlain) {
                mbar_wait(pre_empty, pre_phase ^ 1);
                mbar_arrive_expect_tx(pre_full, pre_tiles(EPI) * kTile);
                tma_load_2d(pre, &p.pa[gi], pre_full, it.n0, it.r0);
                tma_load_2d(pre + kHalf, &p.pa[gi], pre_full, it.n0 + 64, it.r0);
                if (EPI == kEpiSwiGLU) {
                    tma_load_2d(pre + kTile, &p.pb[gi], pre_full, it.n0, it.r0);
                    tma_load_2d(pre + kTile + kHalf, &p.pb[gi], pre_full, it.n0 + 64, it.r0);
                }
                pre_phase ^= 1;
            }
        }
    } else if (wg >= NWG && warp != 4 * NWG) {
        // epilogue (the last warpgroup and the producer's warps 1-3): an
        // item's dh and pre-activation tiles -> da and db (or the plain
        // sum), while the consumers run the next item's main loop; 16-byte
        // chunks, two 256-byte rows a warp instruction, up to the
        // segment's end and N
        const int et = threadIdx.x - 128 * NWG - 32;
        uint32_t ph = 0;
        for (int i = blockIdx.x; i < n_items; i += gridDim.x) {
            const Item it = dg_item<BM>(i, p, offs, first, cursor);
            const DGroup& g = p.g[it.group];
            mbar_wait(dh_full, ph);
            if (EPI != kEpiPlain) mbar_wait(pre_full, ph);
            for (int q = et; q < BM * (kBN / 8); q += kEpiThreads) {
                const int row = q >> 4, c = q & 15;
                const int grow = it.r0 + row, col = it.n0 + 8 * c;
                if (grow >= it.r1 || col >= g.N) continue;      // N % 8 == 0: chunks are whole
                const int off = pair_offset(kHalf, row, c, 0);
                const uint4 hv = *reinterpret_cast<const uint4*>(dh + off);
                const int64_t o = (int64_t)grow * g.N + col;
                if (EPI == kEpiPlain) {
                    *reinterpret_cast<uint4*>(g.out0 + o) = hv;
                    continue;
                }
                const uint4 av = *reinterpret_cast<const uint4*>(pre + off);
                const uint4 bv = EPI == kEpiSwiGLU
                                     ? *reinterpret_cast<const uint4*>(pre + kTile + off)
                                     : make_uint4(0u, 0u, 0u, 0u);
                uint4 o0, o1;
                epilogue_chunk<EPI>(hv, av, bv, o0, o1);
                *reinterpret_cast<uint4*>(g.out0 + o) = o0;
                if (EPI == kEpiSwiGLU) *reinterpret_cast<uint4*>(g.out1 + o) = o1;
            }
            // the pre-activation tiles go back to the producer's TMA (the async proxy)
            fence_proxy_async();
            mbar_arrive_if(dh_empty, true);
            if (EPI != kEpiPlain) mbar_arrive_if(pre_empty, true);
            ph ^= 1;
        }
    } else if (wg < NWG) {
        // consumer warpgroup wg: rows [64 wg, 64 wg + 64) of each item's
        // tile.  Every value that steers a wgmma is broadcast from lane 0,
        // so the compiler sees warp-uniform control flow around them.
        float acc[64];
        int s = 0;
        uint32_t phase = 0, dh_phase = 0;
        const int cwg = uniform(wg);
        const int items_u = uniform(n_items);
        unsigned char* mine = dh + cwg * kWgRows * 128;  // its rows of the staged dh tile
        const int rr = 16 * (t >> 5) + ((t & 31) >> 2);
        for (int i = blockIdx.x; i < items_u; i += gridDim.x) {
            const Item it = dg_item<BM>(i, p, offs, first, cursor);
            const DGroup& g = p.g[uniform(it.group)];
            const int steps = uniform(g.pairs * cdiv(g.K, kBK));
#pragma unroll
            for (int j = 0; j < 64; ++j) acc[j] = 0.f;
            for (int kt = 0; kt < steps; ++kt) {
                mbar_wait(&full[s], phase);
                const uint32_t a = smem_u32(ring + s * kStage) + cwg * (kWgRows * kBK * 2);
                const uint32_t b = smem_u32(ring + s * kStage + kABytes);
                fence_operands(acc);
                wgmma_fence();
#pragma unroll
                for (int kk = 0; kk < kBK / 16; ++kk)
                    wgmma_m64n128k16_bf16<0, 0>(acc, sw128_desc(a + kk * 32, 16, 1024),
                                                sw128_desc(b + kk * 32, 16, 1024));
                wgmma_commit();
                fence_operands(acc);
                wgmma_wait<1>();                // stage kt - 1's products are done
                mbar_arrive_if(&empty[s == 0 ? S - 1 : s - 1], lane == 0 && kt > 0);
                if (++s == S) {
                    s = 0;
                    phase ^= 1;
                }
            }
            wgmma_wait<0>();
            fence_operands(acc);
            mbar_arrive_if(&empty[s == 0 ? S - 1 : s - 1], lane == 0 && steps > 0);
            // dh = bf16(acc) into the staged tile once the epilogue has read
            // the last item's: thread t holds rows rr (+ 8) of the
            // warpgroup's 64 and columns 8 j + 2 (t % 4) (+ 1)
            mbar_wait(dh_empty, dh_phase ^ 1);
#pragma unroll
            for (int j = 0; j < kBN / 8; ++j)
#pragma unroll
                for (int half = 0; half < 2; ++half)
                    *reinterpret_cast<__nv_bfloat162*>(
                        mine + pair_offset(kHalf, rr + 8 * half, j, t & 3)) =
                        __floats2bfloat162_rn(acc[4 * j + 2 * half], acc[4 * j + 2 * half + 1]);
            mbar_arrive_if(dh_full, true);
            dh_phase ^= 1;
        }
    }
}

// The launch's plan, from shapes alone (kernels/moe_experts/backward_plan.py
// mirrors it): BM 128 where group 0's segments average 128 rows or more;
// the ring as deep as shared memory allows beside the epilogue tiles, at
// most 8 stages (6 on 128-row tiles); at most (rows0 / BM + n_exp)
// column-tile rows of items for group 0 (each expert adds at most one
// partial row tile) and ceil(rows1 / BM) for group 1; one block an SM,
// never more blocks than items.
struct DPlan {
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

DPlan dg_plan(int epi, int rows0, int n_exp0, int N0, int rows1, int N1, int n_sms) {
    DPlan pl;
    pl.bm = (int64_t)rows0 >= (int64_t)2 * kWgRows * n_exp0 ? 2 * kWgRows : kWgRows;
    const int s = (kSmemLimit - 1024 - dg_epi_bytes(epi, pl.bm) -
                   dg_table_bytes(kMaxStages, n_exp0)) / dg_stage_bytes(pl.bm);
    const int cap = pl.bm > kWgRows ? kTallStages : kMaxStages;
    pl.stages = s < cap ? s : cap;
    pl.smem = dg_smem_bytes(epi, pl.bm, pl.stages, n_exp0);
    const int64_t nc0 = cdiv(N0, kBN), nc1 = cdiv(N1, kBN);
    pl.max_items = ((int64_t)rows0 / pl.bm + n_exp0) * nc0 +
                   (rows1 > 0 ? ((int64_t)rows1 + pl.bm - 1) / pl.bm * nc1 : 0);
    pl.grid = (int)(pl.max_items < n_sms ? pl.max_items : n_sms);
    return pl;
}

template <int EPI, int NWG>
cudaError_t launch_dgrad_one(const DParams& p, const DPlan& pl, cudaStream_t stream) {
    cudaError_t err = cudaFuncSetAttribute(moe_data_grad_kernel<EPI, NWG>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, pl.smem);
    if (err != cudaSuccess) return err;
    moe_data_grad_kernel<EPI, NWG><<<pl.grid, 128 * (NWG + 2), pl.smem, stream>>>(p);
    return cudaGetLastError();
}

template <int EPI>
cudaError_t launch_dgrad(const DParams& p, const DPlan& pl, cudaStream_t stream) {
    return pl.bm == 2 * kWgRows ? launch_dgrad_one<EPI, 2>(p, pl, stream)
                                : launch_dgrad_one<EPI, 1>(p, pl, stream);
}

// -- the grouped weight gradient ----------------------------------------------------

struct WJob {
    const int* offsets;          // (n_exp + 1,) on the device, or null: one segment of `rows`
    int rows, n_exp, M, N;
    int tm, tn;                  // its tiles of 128 along M and of 256 along N
    int first;                   // the job's first item
};

struct WParams {
    CUtensorMap a[kMaxJobs];     // a (rows, M): (M, rows), box (64, 64)
    CUtensorMap b[kMaxJobs];     // b (rows, N): (N, rows), box (64, 64)
    CUtensorMap out[kMaxJobs];   // out (n_exp, M, N): (N, M, n_exp), box (64, 64, 1)
    WJob job[kMaxJobs];
    int n_jobs, n_items, stages;
};

// One ring stage: 64 rows of k, the A tile's 128 columns of M and the B
// tile's 256 of N, as 64-column boxes.
constexpr int kWgStage = 6 * kBox;
constexpr int kWgOut = 8 * kBox;     // two consumer warpgroups' staged 64 x 256 output tiles

__host__ __device__ constexpr int wg_smem_bytes(int stages) {
    return 1024 + stages * kWgStage + kWgOut + stages * 16;
}

struct WItem {
    int job, e, m0, n0, lo, hi;
};

// Item i: jobs in the order given, each expert by expert, its M tiles of
// 128, the N tiles of 256 innermost; the segment's rows [lo, hi) from the device-side
// offsets (clamped to the job's rows).  backward_plan.py mirrors it.
__device__ __forceinline__ WItem wg_item(int i, const WParams& p) {
    WItem it;
    it.job = 0;
    for (int q = 1; q < p.n_jobs; ++q)
        if (p.job[q].first <= i) it.job = q;
    const WJob& j = p.job[it.job];
    const int k = i - j.first, per = j.tm * j.tn;
    it.e = k / per;
    const int rem = k - it.e * per;
    it.m0 = (rem / j.tn) * kBN;
    it.n0 = (rem - (rem / j.tn) * j.tn) * kWgBN;
    it.lo = 0;
    it.hi = j.rows;
    if (j.offsets != nullptr) {
        it.lo = min(max(__ldg(j.offsets + it.e), 0), j.rows);
        it.hi = min(max(__ldg(j.offsets + it.e + 1), it.lo), j.rows);
    }
    return it;
}

// Rows [from, 64) of a 64-row box (128 bytes a row) to zero, by the 128
// threads of a warpgroup.
__device__ __forceinline__ void clear_rows(unsigned char* box, int from, int t) {
    for (int q = from * 8 + t; q < 64 * 8; q += 128)
        *reinterpret_cast<uint4*>(box + q * 16) = make_uint4(0u, 0u, 0u, 0u);
}

// Three warpgroups: two consumers (64 rows of M each) and a producer.
// Dynamic shared memory: the ring (1024-byte aligned stages), the staged
// output tiles, the barriers.
__global__ void __launch_bounds__(384, 1)
moe_weight_grad_kernel(const __grid_constant__ WParams p) {
    extern __shared__ unsigned char smem_raw[];
    unsigned char* ring = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
    const int S = p.stages;
    unsigned char* staged = ring + S * kWgStage;
    uint64_t* full = reinterpret_cast<uint64_t*>(staged + kWgOut);
    uint64_t* empty = full + S;
    const int lane = threadIdx.x & 31;
    if (threadIdx.x == 0) {
        for (int s = 0; s < S; ++s) {
            mbar_init(&full[s], 1);
            mbar_init(&empty[s], 8);             // lane 0 of every consumer warp
        }
        mbar_fence_init();
    }
    __syncthreads();

    const int wg = threadIdx.x >> 7;
    if (wg == 2) {
        reg_dealloc<40>();
        if (threadIdx.x != 256) return;
        int s = 0;
        uint32_t phase = 0;
        for (int i = blockIdx.x; i < p.n_items; i += gridDim.x) {
            const WItem it = wg_item(i, p);
            const int steps = cdiv(it.hi - it.lo, kBK);
            for (int kt = 0; kt < steps; ++kt) {
                mbar_wait(&empty[s], phase ^ 1);
                unsigned char* st = ring + s * kWgStage;
                mbar_arrive_expect_tx(&full[s], kWgStage);
                const int r = it.lo + kt * kBK;
                tma_load_2d(st, &p.a[it.job], &full[s], it.m0, r);
                tma_load_2d(st + kBox, &p.a[it.job], &full[s], it.m0 + 64, r);
#pragma unroll
                for (int c = 0; c < kWgBN / 64; ++c)
                    tma_load_2d(st + (2 + c) * kBox, &p.b[it.job], &full[s], it.n0 + 64 * c, r);
                if (++s == S) {
                    s = 0;
                    phase ^= 1;
                }
            }
        }
    } else {
        // consumer warpgroup wg: rows [m0 + 64 wg, + 64) of M; values that
        // steer a wgmma are broadcast from lane 0 (warp-uniform control flow)
        reg_alloc<232>();
        float acc[128];
        int s = 0;
        uint32_t phase = 0;
        const int t = threadIdx.x & 127;
        const int cwg = uniform(wg);
        const int items_u = uniform(p.n_items);
        unsigned char* out_tile = staged + cwg * (kWgBN / 64) * kBox;
        const int rr = 16 * (t >> 5) + ((t & 31) >> 2);
        for (int i = blockIdx.x; i < items_u; i += gridDim.x) {
            const WItem it = wg_item(i, p);
            const int lo = uniform(it.lo), hi = uniform(it.hi);
            const int steps = cdiv(hi - lo, kBK);
#pragma unroll
            for (int j = 0; j < 128; ++j) acc[j] = 0.f;
            for (int kt = 0; kt < steps; ++kt) {
                mbar_wait(&full[s], phase);
                unsigned char* st = ring + s * kWgStage;
                const int valid = hi - lo - kt * kBK;
                if (valid < kBK) {
                    // the segment's last stage: rows at or past hi belong to
                    // the next expert; clear them in this warpgroup's A box
                    // and in B boxes 2 cwg, 2 cwg + 1 before either
                    // warpgroup's wgmma
                    clear_rows(st + cwg * kBox, valid, t);
                    clear_rows(st + (2 + 2 * cwg) * kBox, valid, t);
                    clear_rows(st + (3 + 2 * cwg) * kBox, valid, t);
                    fence_proxy_async();
                    named_bar_sync(1, 256);
                }
                const uint32_t a = smem_u32(st + cwg * kBox), b = smem_u32(st + 2 * kBox);
                fence_operands(acc);
                wgmma_fence();
#pragma unroll
                for (int kk = 0; kk < kBK / 16; ++kk)
                    wgmma_m64n256k16_bf16<1, 1>(acc, sw128_desc(a + kk * 2048, kBox, 1024),
                                                sw128_desc(b + kk * 2048, kBox, 1024));
                wgmma_commit();
                fence_operands(acc);
                wgmma_wait<1>();
                mbar_arrive_if(&empty[s == 0 ? S - 1 : s - 1], lane == 0 && kt > 0);
                if (++s == S) {
                    s = 0;
                    phase ^= 1;
                }
            }
            wgmma_wait<0>();
            fence_operands(acc);
            mbar_arrive_if(&empty[s == 0 ? S - 1 : s - 1], lane == 0 && steps > 0);

            // epilogue: bf16(acc) into the warpgroup's staged tile (four
            // 64-column boxes, 128-byte swizzle), then one thread stores it
            // by TMA (nothing outside the tensor is written) while the next
            // item's main loop runs
            if (t == 0) bulk_wait_read<0>();   // the last item's stores have read the tile
            named_bar_sync(2 + cwg, 128);
#pragma unroll
            for (int j = 0; j < kWgBN / 8; ++j)
#pragma unroll
                for (int half = 0; half < 2; ++half)
                    *reinterpret_cast<__nv_bfloat162*>(
                        out_tile + pair_offset(kBox, rr + 8 * half, j, t & 3)) =
                        __floats2bfloat162_rn(acc[4 * j + 2 * half], acc[4 * j + 2 * half + 1]);
            fence_proxy_async();
            named_bar_sync(2 + cwg, 128);
            if (t == 0) {
                const int m = it.m0 + kWgRows * cwg;
#pragma unroll
                for (int c = 0; c < kWgBN / 64; ++c)
                    tma_store_3d(&p.out[it.job], out_tile + c * kBox, it.n0 + 64 * c, m, it.e);
                bulk_commit();
            }
        }
        if (t == 0) bulk_wait<0>();
    }
}

// The launch's plan (backward_plan.py mirrors it): the ring as deep as
// shared memory allows beside the staged output tiles, at most 8 stages;
// the items of every job; one block an SM, never more blocks than items.
struct WPlan {
    int stages, smem, grid;
    int64_t items;
};

WPlan wg_plan(const int* dims, int n_jobs, int n_sms) {
    WPlan pl;
    const int s = (kSmemLimit - 1024 - kWgOut - kMaxStages * 16) / kWgStage;
    pl.stages = s < kMaxStages ? s : kMaxStages;
    pl.smem = wg_smem_bytes(pl.stages);
    pl.items = 0;
    for (int i = 0; i < n_jobs; ++i)
        pl.items += (int64_t)dims[4 * i + 1] * cdiv(dims[4 * i + 2], kBN) *
                    cdiv(dims[4 * i + 3], kWgBN);
    pl.grid = (int)(pl.items < n_sms ? pl.items : n_sms);
    return pl;
}

// -- combine backward ---------------------------------------------------------------

// A warp a pair q = t k + j (sorted row pos[q]): dys[pos[q]] = kept ?
// bf16(dout[t] bf16(w[q])) : 0, one product and one rounding an element;
// dweights[q] = kept ? sum_d dout[t, d] ys[pos[q], d] : 0 in fp32, lane l
// summing the 8-column chunks l, l + 32, ... in order (each product of two
// bf16 values exact in fp32), then the lanes' sums by an xor butterfly
// (16, 8, 4, 2, 1): the order ref.py::moe_combine_backward_plain follows,
// so both outputs are bitwise their plain version.
__global__ void __launch_bounds__(kThreads)
moe_combine_backward_kernel(const __nv_bfloat16* __restrict__ dout,
                            const __nv_bfloat16* __restrict__ ys, const int* __restrict__ pos,
                            const float* __restrict__ weights,
                            const unsigned char* __restrict__ kept,
                            __nv_bfloat16* __restrict__ dys, float* __restrict__ dweights, int T,
                            int D, int k) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int64_t q = (int64_t)blockIdx.x * (kThreads / 32) + warp;
    if (q >= (int64_t)T * k) return;
    const int64_t t = q / k, row = __ldg(pos + q);
    const bool keep = kept == nullptr || __ldg(kept + q) != 0;
    const float wb = round_bf16(__ldg(weights + q));
    const uint4* g = reinterpret_cast<const uint4*>(dout + t * D);
    const uint4* y = reinterpret_cast<const uint4*>(ys + row * D);
    uint4* o = reinterpret_cast<uint4*>(dys + row * D);
    float acc = 0.f;
    for (int c = lane; c < D / 8; c += 32) {
        uint4 res = make_uint4(0u, 0u, 0u, 0u);
        if (keep) {
            const uint4 gv = __ldg(g + c), yv = __ldg(y + c);
            const __nv_bfloat16* gb = reinterpret_cast<const __nv_bfloat16*>(&gv);
            const __nv_bfloat16* yb = reinterpret_cast<const __nv_bfloat16*>(&yv);
            __nv_bfloat16* ob = reinterpret_cast<__nv_bfloat16*>(&res);
#pragma unroll
            for (int i = 0; i < 8; ++i) {
                const float gf = __bfloat162float(gb[i]);
                acc = __fadd_rn(acc, __fmul_rn(gf, __bfloat162float(yb[i])));
                ob[i] = __float2bfloat16_rn(__fmul_rn(gf, wb));
            }
        }
        o[c] = res;
    }
#pragma unroll
    for (int m = 16; m > 0; m >>= 1) acc = __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, m));
    if (lane == 0) dweights[q] = keep ? acc : 0.f;
}

// -- route backward -----------------------------------------------------------------

constexpr int kRbTokens = 64;        // the dx launch: tokens a block
constexpr int kRbDlStride = kRbTokens + 4;  // dlogits (E, 64 tokens) in shared memory, padded
constexpr int kRbStages = 2;         // the dx launch's ring of w chunks
constexpr int kRbBatch = 4;          // tokens a warp takes through their dlogits at once
constexpr int kRbWThreads = 128;     // the dw launch: threads a half-block at most
constexpr int kRbMaxDt = 256;        // the dw launch: columns of D a block at most
constexpr int kRbWTokens = 32;       // the dw launch: tokens a stage
constexpr int kRbWStages = 4;
constexpr int kRbMaxSplits = 8;      // the dw launch: token splits, summed in order
constexpr int kRbSplitTokens = 1024; // tokens a split at least
constexpr int kRbMaxE = 128, kRbMaxK = 32, kRbMaxD = 4096;
constexpr int kRbCounters = 256;     // ints of the counter buffer: one a D tile

// Two launches.  dx: a block a tile of 64 tokens (8 warps, each 8 tokens),
// its tokens' dlogits once (into shared memory and the workspace), then dx
// = dlogits . w^T over D in chunks of dc columns (w rows staged by 16-byte
// cp.async at a stride of wst floats, 4 mod 8, so 8 lanes reading 8 rows'
// float4 meet no bank twice): lane c of warp w holds tokens 8w .. 8w + 7 x
// columns c + 32 i (i < ci), an FMA chain over e in order from 0, four e
// a shared-memory load of w.  dw: grid (D tiles of dt, token splits), a
// thread 8 d x 8 e (the experts padded to ep = 8 ne, ne a power of two; e
// 4c .. 4c + 3 and ep / 2 + 4c ..; wthreads = 2 ne dt / 8 threads, at most
// 256, dt at most 256), an FMA chain over
// its half of each 32-token stage of its split, in token order from 0 (x
// and dlogits rows), the halves added; the splits' partials meet in the
// workspace and the last block of a D tile adds them in split order.
struct RbShape {
    int n_tok_tiles, ci, dc, n_chunks, wst, dx_smem;
    int ne, ep, dt, wthreads, n_dt, split, splits, dw_smem;
    int64_t dl_floats, part_floats, ws_bytes;
};

RbShape rb_shape(int T, int D, int E) {
    RbShape s;
    s.n_tok_tiles = cdiv(T, kRbTokens);
    s.ci = E <= 64 ? 8 : 4;
    s.dc = 32 * s.ci;
    s.n_chunks = cdiv(D, s.dc);
    s.wst = ((E + 3) & ~3) + 4;
    s.dx_smem = (E * kRbDlStride + 8 * kRbBatch * E + kRbStages * s.dc * s.wst) * 4;
    s.ne = 1;
    while (8 * s.ne < E) s.ne *= 2;
    s.ep = 8 * s.ne;
    s.dt = 8 * min(kRbWThreads / s.ne, kRbMaxDt / 8);
    s.wthreads = 2 * s.ne * s.dt / 8;
    s.n_dt = cdiv(D, s.dt);
    const int want = min(kRbMaxSplits, max(1, T / kRbSplitTokens));
    s.split = cdiv(cdiv(T, want), kRbWTokens) * kRbWTokens;
    s.splits = cdiv(T, s.split);
    s.dw_smem = kRbWStages * kRbWTokens * (s.dt * 2 + s.ep * 4);
    s.dl_floats = ((int64_t)T * E + 3) & ~(int64_t)3;
    s.part_floats = s.splits > 1 ? (int64_t)s.splits * D * E : 0;
    s.ws_bytes = (s.dl_floats + s.part_floats) * 4;
    return s;
}

struct RbParams {
    const __nv_bfloat16* x;      // (T, D)
    const float* w;              // (D, E)
    const float* gates;          // (T, E)
    const float* weights;        // (T, k)
    const int* idx;              // (T, k)
    const float* dweights;       // (T, k)
    const float* dgates;         // (T, E) or null
    __nv_bfloat16* dx;           // (T, D)
    float* dw;                   // (D, E)
    float* dl;                   // (T, E): the dlogits (workspace)
    float* part;                 // (splits, D, E) when splits > 1 (workspace)
    int* counters;               // (kRbCounters,), zero between launches
    int T, D, E, k;
    bool x_vec;                  // 16-byte copies of x rows (D % 8 == 0)
    bool dl_vec;                 // 16-byte copies of dlogits rows (E % 4 == 0)
    bool w_vec;                  // 16-byte copies of w rows (E % 4 == 0, w 16-byte aligned)
    RbShape s;
};

template <int BYTES>
__device__ __forceinline__ void rb_cp_async(void* dst, const void* src) {
    if constexpr (BYTES == 16)
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src)
                     : "memory");
    else
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(dst)), "l"(src)
                     : "memory");
}

__device__ __forceinline__ void rb_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void rb_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// dlogits of tokens t0 .. t0 + B - 1 into rows (B rows of E floats), one
// warp, the B tokens at once: the renormalisation's adjoint (weights = v /
// max(sum_j v_j, 1e-9), v the k chosen gates, the sums in order j), dv_j =
// (dw_j - [s >= 1e-9] sum_i dw_i w_i) / max(s, 1e-9); dgates plus dv
// scattered to the chosen experts in order j; then the softmax's adjoint g
// (dg - sum_e g dg), each lane's 4 experts an FMA chain from 0, the lanes'
// sums an xor reduction.  A row past T is zero.
template <int B>
__device__ void tokens_dlogits(const RbParams& p, int t0, float* rows) {
    const int lane = threadIdx.x & 31, E = p.E, k = p.k;
    constexpr int C = kRbMaxE / 32;
    bool ok[B];
    int ij[B];
    float v[B], pw[B], dwj[B], s[B], dot[B], dv[B], g[B][C], sum[B];
#pragma unroll
    for (int q = 0; q < B; ++q) {
        const int t = t0 + q;
        ok[q] = t < p.T;
        const int64_t tk = (int64_t)t * k;
        const bool mine = ok[q] && lane < k;
        ij[q] = mine ? min(max(__ldg(p.idx + tk + lane), 0), E - 1) : 0;
        const float wj = mine ? __ldg(p.weights + tk + lane) : 0.f;
        dwj[q] = mine ? __ldg(p.dweights + tk + lane) : 0.f;
        pw[q] = __fmul_rn(dwj[q], wj);
    }
#pragma unroll
    for (int q = 0; q < B; ++q) {
        const int64_t tE = (int64_t)(t0 + q) * E;
        v[q] = ok[q] && lane < k ? __ldg(p.gates + tE + ij[q]) : 0.f;
        float* row = rows + q * E;
#pragma unroll
        for (int c = 0; c < C; ++c) {
            const int e = lane + 32 * c;
            g[q][c] = ok[q] && e < E ? __ldg(p.gates + tE + e) : 0.f;
            if (e < E)
                row[e] = ok[q] && p.dgates != nullptr ? __ldg(p.dgates + tE + e) : 0.f;
        }
    }
    for (int j = 0; j < k; ++j) {
#pragma unroll
        for (int q = 0; q < B; ++q) {
            const float vj = __shfl_sync(0xffffffffu, v[q], j);
            const float pj = __shfl_sync(0xffffffffu, pw[q], j);
            s[q] = j == 0 ? vj : __fadd_rn(s[q], vj);
            dot[q] = j == 0 ? pj : __fadd_rn(dot[q], pj);
        }
    }
#pragma unroll
    for (int q = 0; q < B; ++q) {
        const float den = s[q] < 1e-9f ? 1e-9f : s[q];
        dv[q] = __fdiv_rn(__fsub_rn(dwj[q], s[q] >= 1e-9f ? dot[q] : 0.f), den);
    }
    __syncwarp();
    for (int j = 0; j < k; ++j) {
#pragma unroll
        for (int q = 0; q < B; ++q) {
            const float dvj = __shfl_sync(0xffffffffu, dv[q], j);
            const int ej = __shfl_sync(0xffffffffu, ij[q], j);
            if (lane == 0 && ok[q]) rows[q * E + ej] = __fadd_rn(rows[q * E + ej], dvj);
        }
        __syncwarp();
    }
    float dg[B][C];
#pragma unroll
    for (int q = 0; q < B; ++q) {
        sum[q] = 0.f;
#pragma unroll
        for (int c = 0; c < C; ++c) {
            const int e = lane + 32 * c;
            dg[q][c] = e < E ? rows[q * E + e] : 0.f;
            sum[q] = fmaf(g[q][c], dg[q][c], sum[q]);
        }
    }
#pragma unroll
    for (int m = 16; m > 0; m >>= 1)
#pragma unroll
        for (int q = 0; q < B; ++q)
            sum[q] = __fadd_rn(sum[q], __shfl_xor_sync(0xffffffffu, sum[q], m));
    __syncwarp();
#pragma unroll
    for (int q = 0; q < B; ++q)
#pragma unroll
        for (int c = 0; c < C; ++c) {
            const int e = lane + 32 * c;
            if (e < E) rows[q * E + e] = ok[q] ? g[q][c] * (dg[q][c] - sum[q]) : 0.f;
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

// Chunk ch of w's rows (dc rows d0 .., E floats each) into stage, at a
// stride of wst floats, 16 bytes a copy where E % 4 == 0 (rows past D are
// left as they are).  One group.
__device__ __forceinline__ void rb_stage_w(const RbParams& p, int ch, float* stage) {
    const int d0 = ch * p.s.dc, nd = min(p.s.dc, p.D - d0), E = p.E, wst = p.s.wst;
    const float* src = p.w + (int64_t)d0 * E;
    if (p.w_vec) {
        const int e4 = E / 4;
        for (int i = threadIdx.x; i < nd * e4; i += kThreads) {
            const int d = i / e4, c = i - d * e4;
            rb_cp_async<16>(stage + d * wst + 4 * c, src + (int64_t)d * E + 4 * c);
        }
    } else {
        for (int i = threadIdx.x; i < nd * E; i += kThreads) {
            const int d = i / E;
            rb_cp_async<4>(stage + d * wst + i - d * E, src + i);
        }
    }
    rb_commit();
}

// dx launch (grid: token tiles of 64).  Each token's dlogits once (a warp
// 8 tokens, tokens_dlogits), kept transposed in shared memory (E, 64 + 4)
// and written to the workspace for the dw launch; then dx over D in chunks
// of dc columns through a two-stage ring of w rows: dx[t, d] = bf16(sum_e
// dl[t, e] w[d, e]), one FMA chain in e order from 0 (the order of the
// earlier route backward kernel, so dx stays bitwise).
template <int CI>
__global__ void __launch_bounds__(kThreads) moe_route_backward_dx_kernel(const RbParams p) {
    extern __shared__ __align__(16) float rsm[];
    const RbShape& s = p.s;
    const int E = p.E, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int t0 = blockIdx.x * kRbTokens;
    float* dls = rsm;                                // (E, 68): dlogits, token-minor
    float* rows = dls + E * kRbDlStride;             // (8 warps, kRbBatch, E): dlogits rows
    float* wst = rows + 8 * kRbBatch * E;            // (stages, dc, wst)
    const int wsz = s.dc * s.wst;
    for (int i = 0; i < kRbStages; ++i) {
        if (i < s.n_chunks) rb_stage_w(p, i, wst + i * wsz);
        else rb_commit();
    }
    float* row = rows + warp * kRbBatch * E;
    for (int h = 0; h < 8; h += kRbBatch) {
        tokens_dlogits<kRbBatch>(p, t0 + 8 * warp + h, row);
        __syncwarp();
        for (int q = 0; q < kRbBatch; ++q) {
            const int tl = 8 * warp + h + q, t = t0 + tl;
            for (int e = lane; e < E; e += 32) {
                dls[e * kRbDlStride + tl] = row[q * E + e];
                if (t < p.T) p.dl[(int64_t)t * E + e] = row[q * E + e];
            }
        }
        __syncwarp();
    }
    const int nt = min(8, max(0, p.T - (t0 + 8 * warp)));   // this warp's tokens in T
    for (int ch = 0; ch < s.n_chunks; ++ch) {
        rb_wait<kRbStages - 1>();
        __syncthreads();
        const float* ws = wst + (ch % kRbStages) * wsz + lane * s.wst;
        const float* dl = dls + 8 * warp;
        float acc[8][CI];
#pragma unroll
        for (int a = 0; a < 8; ++a)
#pragma unroll
            for (int b = 0; b < CI; ++b) acc[a][b] = 0.f;
        const int e4 = E & ~3;
        for (int e0 = 0; e0 < e4; e0 += 4) {
            float4 w4[CI];
#pragma unroll
            for (int b = 0; b < CI; ++b)
                w4[b] = *reinterpret_cast<const float4*>(ws + 32 * b * s.wst + e0);
#pragma unroll
            for (int q = 0; q < 4; ++q) {
                const float* de = dl + (e0 + q) * kRbDlStride;
                const float4 g0 = *reinterpret_cast<const float4*>(de);
                const float4 g1 = *reinterpret_cast<const float4*>(de + 4);
                const float gv[8] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
#pragma unroll
                for (int a = 0; a < 8; ++a)
#pragma unroll
                    for (int b = 0; b < CI; ++b) {
                        const float wq = q == 0 ? w4[b].x : q == 1 ? w4[b].y : q == 2 ? w4[b].z
                                                                                   : w4[b].w;
                        acc[a][b] = fmaf(gv[a], wq, acc[a][b]);
                    }
            }
        }
        for (int e = e4; e < E; ++e) {
            const float4 g0 = *reinterpret_cast<const float4*>(dl + e * kRbDlStride);
            const float4 g1 = *reinterpret_cast<const float4*>(dl + e * kRbDlStride + 4);
            const float gv[8] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
#pragma unroll
            for (int a = 0; a < 8; ++a)
#pragma unroll
                for (int b = 0; b < CI; ++b)
                    acc[a][b] = fmaf(gv[a], ws[32 * b * s.wst + e], acc[a][b]);
        }
        const int d0 = ch * s.dc;
#pragma unroll
        for (int a = 0; a < 8; ++a) {
            if (a >= nt) break;
            __nv_bfloat16* dst = p.dx + (int64_t)(t0 + 8 * warp + a) * p.D + d0 + lane;
#pragma unroll
            for (int b = 0; b < CI; ++b)
                if (d0 + lane + 32 * b < p.D) dst[32 * b] = __float2bfloat16_rn(acc[a][b]);
        }
        __syncthreads();                     // the stage is refilled next
        if (ch + kRbStages < s.n_chunks)
            rb_stage_w(p, ch + kRbStages, wst + (ch % kRbStages) * wsz);
        else
            rb_commit();
    }
}

// Stage i of the dw launch's split (tokens ts + 32 i ..): x rows (32, dt)
// bf16 (columns d0 .. within D) and dlogits rows (32, ep) fp32 (E of them);
// tokens past the split's end or T are zero rows.  One group.
__device__ __forceinline__ void rb_stage_dw(const RbParams& p, int t_lo, int t_hi, int d0,
                                            unsigned char* stage) {
    const RbShape& s = p.s;
    const int tid = threadIdx.x, nth = s.wthreads, nd = min(s.dt, p.D - d0), E = p.E;
    __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(stage);
    float* ds = reinterpret_cast<float*>(stage + kRbWTokens * s.dt * 2);
    const int n = t_hi - t_lo;
    if (p.x_vec) {
        const int cpr = s.dt / 8;
        for (int i = tid; i < kRbWTokens * cpr; i += nth) {
            const int r = i / cpr, c = 8 * (i - r * cpr);
            if (r < n && c < nd)
                rb_cp_async<16>(xs + r * s.dt + c, p.x + (int64_t)(t_lo + r) * p.D + d0 + c);
            else
                *reinterpret_cast<uint4*>(xs + r * s.dt + c) = make_uint4(0u, 0u, 0u, 0u);
        }
    } else {
        const int cpr = s.dt / 2;
        for (int i = tid; i < kRbWTokens * cpr; i += nth) {
            const int r = i / cpr, c = 2 * (i - r * cpr);
            if (r < n && c < nd)
                rb_cp_async<4>(xs + r * s.dt + c, p.x + (int64_t)(t_lo + r) * p.D + d0 + c);
            else
                *reinterpret_cast<uint32_t*>(xs + r * s.dt + c) = 0u;
        }
    }
    if (p.dl_vec) {
        const int cpr = E / 4;
        for (int i = tid; i < kRbWTokens * cpr; i += nth) {
            const int r = i / cpr, c = 4 * (i - r * cpr);
            if (r < n) rb_cp_async<16>(ds + r * s.ep + c, p.dl + (int64_t)(t_lo + r) * E + c);
            else *reinterpret_cast<float4*>(ds + r * s.ep + c) = make_float4(0.f, 0.f, 0.f, 0.f);
        }
    } else {
        for (int i = tid; i < kRbWTokens * E; i += nth) {
            const int r = i / E, c = i - r * E;
            if (r < n) rb_cp_async<4>(ds + r * s.ep + c, p.dl + (int64_t)(t_lo + r) * E + c);
            else ds[r * s.ep + c] = 0.f;
        }
    }
    rb_commit();
}

// dw launch (grid: D tiles of dt x token splits; two halves of wthreads).
// Thread (h, dg, eg) holds d0 + 8 dg .. + 7 x experts 4 eg .. + 3 and ep /
// 2 + 4 eg ..: an FMA chain from 0 over the split's tokens in order, half h
// taking tokens 16 h .. 16 h + 15 of every 32-token stage (x from the bf16
// rows, dlogits from the dx launch's workspace, a four-stage cp.async
// ring); the block's partial is half 0's chain + half 1's.  One split
// writes dw; otherwise the partials meet in the workspace and the last
// block of the D tile adds them in split order.
__global__ void __launch_bounds__(2 * kRbWThreads) moe_route_backward_dw_kernel(const RbParams p) {
    extern __shared__ __align__(16) unsigned char wsm[];
    __shared__ int flag;
    const RbShape& s = p.s;
    const int E = p.E, tid = threadIdx.x, nth = s.wthreads, base = nth / 2;
    const int hf = tid / base, ht = tid - hf * base;
    const int eg = ht & (s.ne - 1), dg = ht / s.ne;
    const int d0 = blockIdx.x * s.dt, split = blockIdx.y;
    const int ts = split * s.split, te = min(p.T, ts + s.split);
    const int n_st = cdiv(te - ts, kRbWTokens);
    const int stage_bytes = kRbWTokens * (s.dt * 2 + s.ep * 4), half = s.ep / 2;
    float acc[8][8];
#pragma unroll
    for (int a = 0; a < 8; ++a)
#pragma unroll
        for (int b = 0; b < 8; ++b) acc[a][b] = 0.f;
    for (int i = 0; i < kRbWStages - 1; ++i) {
        if (i < n_st) rb_stage_dw(p, ts + i * kRbWTokens, min(te, ts + (i + 1) * kRbWTokens), d0,
                                  wsm + i * stage_bytes);
        else rb_commit();
    }
    for (int i = 0; i < n_st; ++i) {
        const int ahead = i + kRbWStages - 1;
        if (ahead < n_st)
            rb_stage_dw(p, ts + ahead * kRbWTokens, min(te, ts + (ahead + 1) * kRbWTokens), d0,
                        wsm + (ahead % kRbWStages) * stage_bytes);
        else
            rb_commit();
        rb_wait<kRbWStages - 1>();
        __syncthreads();
        const unsigned char* st = wsm + (i % kRbWStages) * stage_bytes;
        const __nv_bfloat16* xs = reinterpret_cast<const __nv_bfloat16*>(st) + 8 * dg;
        const float* ds = reinterpret_cast<const float*>(st + kRbWTokens * s.dt * 2) + 4 * eg;
        const int n = min(kRbWTokens, te - ts - i * kRbWTokens);
        const int r_end = min(n, (hf + 1) * (kRbWTokens / 2));
#pragma unroll 2
        for (int r = hf * (kRbWTokens / 2); r < r_end; ++r) {
            const uint4 xr = *reinterpret_cast<const uint4*>(xs + r * s.dt);
            const __nv_bfloat162* xp = reinterpret_cast<const __nv_bfloat162*>(&xr);
            float xv[8];
#pragma unroll
            for (int q = 0; q < 4; ++q) {
                const float2 f = __bfloat1622float2(xp[q]);
                xv[2 * q] = f.x;
                xv[2 * q + 1] = f.y;
            }
            const float4 g0 = *reinterpret_cast<const float4*>(ds + r * s.ep);
            const float4 g1 = *reinterpret_cast<const float4*>(ds + r * s.ep + half);
            const float gv[8] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
#pragma unroll
            for (int a = 0; a < 8; ++a)
#pragma unroll
                for (int b = 0; b < 8; ++b) acc[a][b] = fmaf(xv[a], gv[b], acc[a][b]);
        }
        __syncthreads();                     // the stage is refilled next
    }
    float* xch = reinterpret_cast<float*>(wsm);      // (base, 64): half 1's chains
    if (hf == 1) {
#pragma unroll
        for (int a = 0; a < 8; ++a)
#pragma unroll
            for (int b = 0; b < 8; ++b) xch[(8 * a + b) * base + ht] = acc[a][b];
    }
    __syncthreads();
    float* dst = s.splits > 1 ? p.part + (int64_t)split * p.D * E : p.dw;
    if (hf == 0) {
#pragma unroll
        for (int a = 0; a < 8; ++a) {
            const int d = d0 + 8 * dg + a;
            if (d >= p.D) break;
#pragma unroll
            for (int b = 0; b < 8; ++b) {
                const int e = (b < 4 ? 0 : half) + 4 * eg + (b & 3);
                if (e < E)
                    dst[(int64_t)d * E + e] = __fadd_rn(acc[a][b], xch[(8 * a + b) * base + ht]);
            }
        }
    }
    if (s.splits == 1) return;
    if (!last_to_arrive(p.counters + blockIdx.x, s.splits, &flag)) return;
    const int64_t lo = (int64_t)d0 * E, hi = (int64_t)min(p.D, d0 + s.dt) * E;
    const int64_t stride = (int64_t)p.D * E;
    const int vw = p.dl_vec ? 4 : 1;     // E % 4 == 0: the tile's range is float4 aligned
#pragma unroll 2
    for (int64_t q = lo + vw * tid; q < hi; q += vw * nth) {
        float v[kRbMaxSplits][4];
#pragma unroll
        for (int sp = 0; sp < kRbMaxSplits; ++sp) {
            if (sp >= s.splits) break;
            if (vw == 4) {
                const float4 f = __ldcg(reinterpret_cast<const float4*>(p.part + sp * stride + q));
                v[sp][0] = f.x;
                v[sp][1] = f.y;
                v[sp][2] = f.z;
                v[sp][3] = f.w;
            } else {
                v[sp][0] = __ldcg(p.part + sp * stride + q);
            }
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            if (j >= vw) break;
            float sum = v[0][j];
#pragma unroll
            for (int sp = 1; sp < kRbMaxSplits; ++sp)
                if (sp < s.splits) sum = __fadd_rn(sum, v[sp][j]);
            p.dw[q + j] = sum;
        }
    }
}

template <int CI>
cudaError_t launch_route_backward(const RbParams& p, cudaStream_t stream) {
    cudaError_t err = cudaFuncSetAttribute(moe_route_backward_dx_kernel<CI>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           p.s.dx_smem);
    if (err != cudaSuccess) return err;
    moe_route_backward_dx_kernel<CI><<<p.s.n_tok_tiles, kThreads, p.s.dx_smem, stream>>>(p);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(moe_route_backward_dw_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, p.s.dw_smem);
    if (err != cudaSuccess) return err;
    moe_route_backward_dw_kernel<<<dim3(p.s.n_dt, p.s.splits), p.s.wthreads, p.s.dw_smem,
                                   stream>>>(p);
    return cudaGetLastError();
}

// A group's tensor maps: the A operands (rows, K) with a box of 64 k x BM
// rows, the weights (n_exp, N, K) with a box of 64 k x 128 n of one expert,
// the pre-activations (rows, N) with a box of 64 columns x BM rows.
// q: the group's 9 pointers of moe_data_grad_launch.
bool encode_dgroup(DParams& p, int gi, const void* const* q, int bm) {
    const DGroup& g = p.g[gi];
    const uint64_t da[2] = {(uint64_t)g.K, (uint64_t)g.rows}, sa[1] = {(uint64_t)g.K * 2};
    const uint32_t ba[2] = {kBK, (uint32_t)bm};
    const uint64_t dw[3] = {(uint64_t)g.K, (uint64_t)g.N, (uint64_t)g.n_exp};
    const uint64_t sw[2] = {(uint64_t)g.K * 2, (uint64_t)g.N * g.K * 2};
    const uint32_t bw[3] = {kBK, kBN, 1};
    const uint64_t dp[2] = {(uint64_t)g.N, (uint64_t)g.rows}, sp[1] = {(uint64_t)g.N * 2};
    const uint32_t bp[2] = {64, (uint32_t)bm};
    if (!encode_bf16_sw128(&p.a0[gi], q[0], 2, da, sa, ba) ||
        !encode_bf16_sw128(&p.w0[gi], q[2], 3, dw, sw, bw))
        return false;
    if (g.pairs == 2 && (!encode_bf16_sw128(&p.a1[gi], q[1], 2, da, sa, ba) ||
                         !encode_bf16_sw128(&p.w1[gi], q[3], 3, dw, sw, bw)))
        return false;
    return (q[5] == nullptr || encode_bf16_sw128(&p.pa[gi], q[5], 2, dp, sp, bp)) &&
           (q[6] == nullptr || encode_bf16_sw128(&p.pb[gi], q[6], 2, dp, sp, bp));
}

// A job's tensor maps: a (rows, M) and b (rows, N) with boxes of 64
// columns x 64 rows, out (n_exp, M, N) with a box of 64 x 64 of one expert.
bool encode_wjob(WParams& p, int i, const void* a, const void* b, const void* out) {
    const WJob& j = p.job[i];
    const uint32_t box[3] = {64, kBK, 1};
    const uint64_t dout[3] = {(uint64_t)j.N, (uint64_t)j.M, (uint64_t)j.n_exp};
    const uint64_t sout[2] = {(uint64_t)j.N * 2, (uint64_t)j.M * j.N * 2};
    if (!encode_bf16_sw128(&p.out[i], out, 3, dout, sout, box)) return false;
    if (j.rows == 0) return true;
    const uint64_t da[2] = {(uint64_t)j.M, (uint64_t)j.rows}, sa[1] = {(uint64_t)j.M * 2};
    const uint64_t db[2] = {(uint64_t)j.N, (uint64_t)j.rows}, sb[1] = {(uint64_t)j.N * 2};
    return encode_bf16_sw128(&p.a[i], a, 2, da, sa, box) &&
           encode_bf16_sw128(&p.b[i], b, 2, db, sb, box);
}

bool misaligned(const void* p) { return reinterpret_cast<uintptr_t>(p) & 15; }

}  // namespace

extern "C" {

// dys (P, D) bf16 in sorted order and dweights (T, k) fp32 from dout (T, D)
// bf16, ys (P, D) bf16, pos (T k,) int32, weights (T, k) fp32 and kept (T
// k,) bytes or null; P = T k, D a multiple of 8, the bf16 rows 16-byte
// aligned.  Returns a cudaError_t (cudaErrorInvalidValue for a shape the
// kernel does not take).
int moe_combine_backward_launch(const void* dout, const void* ys, const void* pos,
                                const void* weights, const void* kept, void* dys, void* dweights,
                                int T, int D, int k, void* stream) {
    if (T < 1 || D < 8 || D % 8 || k < 1 || misaligned(dout) || misaligned(ys) || misaligned(dys))
        return (int)cudaErrorInvalidValue;
    const int64_t blocks = ((int64_t)T * k + kThreads / 32 - 1) / (kThreads / 32);
    if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    moe_combine_backward_kernel<<<(unsigned)blocks, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(dout), static_cast<const __nv_bfloat16*>(ys),
        static_cast<const int*>(pos), static_cast<const float*>(weights),
        static_cast<const unsigned char*>(kept), static_cast<__nv_bfloat16*>(dys),
        static_cast<float*>(dweights), T, D, k);
    return (int)cudaGetLastError();
}

// The plan moe_data_grad_launch makes for these shapes on the current
// device: out[0] rows per tile (BM), out[1] ring stages, out[2] dynamic
// shared memory bytes, out[3] blocks, out[4] the item bound the grid was
// sized from (clamped to 2^31 - 1).
int moe_data_grad_plan(int epi, int rows0, int n_exp0, int N0, int rows1, int N1, int* out) {
    if (epi < 0 || epi > 2 || rows0 < 0 || n_exp0 < 1 || n_exp0 > kMaxExperts || rows1 < 0 ||
        out == nullptr)
        return (int)cudaErrorInvalidValue;
    const DPlan pl = dg_plan(epi, rows0, n_exp0, N0, rows1, N1, sm_count());
    out[0] = pl.bm;
    out[1] = pl.stages;
    out[2] = pl.smem;
    out[3] = pl.grid;
    out[4] = (int)(pl.max_items < 0x7fffffff ? pl.max_items : 0x7fffffff);
    return 0;
}

// One launch of the grouped data gradient.  epi (ref.py's MODES): 0
// SwiGLU backward (out0 = da, out1 = db, from pre_a = the forward's gate
// rows and pre_b its up rows), 1 GELU backward (out0 = da, pre_a the up
// rows), 2 plain (out0 = bf16 of the sum).  ptrs: 9 a group (g0, g1, w0, w1, offsets, pre_a,
// pre_b, out0, out1), dims: 4 a group (rows, n_exp, N, K); group 1 is
// absent when its rows are 0 and takes null offsets (one segment).  Each
// group's A operands are (rows, K), its weights (n_exp, N, K), its outputs
// (rows, N); all bf16, 16-byte aligned; N and K multiples of 8; g1 and w1
// (a second operand pair, summed into the same product) or neither.
// Returns a cudaError_t: cudaErrorInvalidValue for a shape the kernel does
// not take, cudaErrorNotSupported when the CUDA driver encodes no tensor
// map for it.
int moe_data_grad_launch(int epi, const void* const* ptrs, const int* dims, void* stream) {
    if (epi < 0 || epi > 2 || ptrs == nullptr || dims == nullptr) return (int)cudaErrorInvalidValue;
    DParams p;
    memset(&p, 0, sizeof(p));
    for (int gi = 0; gi < 2; ++gi) {
        const void* const* q = ptrs + 9 * gi;
        const int* d = dims + 4 * gi;
        DGroup& g = p.g[gi];
        g.offsets = static_cast<const int*>(q[4]);
        g.out0 = static_cast<__nv_bfloat16*>(const_cast<void*>(q[7]));
        g.out1 = static_cast<__nv_bfloat16*>(const_cast<void*>(q[8]));
        g.rows = d[0];
        g.n_exp = d[1];
        g.N = d[2];
        g.K = d[3];
        g.pairs = q[1] != nullptr ? 2 : 1;
        if (gi == 1 && g.rows == 0) break;
        if (g.rows < 0 || g.n_exp < 1 || g.n_exp > kMaxExperts || g.N < 8 || g.N % 8 ||
            g.K < 8 || g.K % 8 || (gi == 0 && g.offsets == nullptr) ||
            (gi == 1 && (g.offsets != nullptr || g.n_exp != 1)))
            return (int)cudaErrorInvalidValue;
        if (q[0] == nullptr || q[2] == nullptr || g.out0 == nullptr ||
            (q[1] == nullptr) != (q[3] == nullptr) ||
            (epi != kEpiPlain && q[5] == nullptr) ||
            (epi == kEpiSwiGLU && (q[6] == nullptr || g.out1 == nullptr)))
            return (int)cudaErrorInvalidValue;
        for (int i = 0; i < 9; ++i)
            if (misaligned(q[i]) && i != 4) return (int)cudaErrorInvalidValue;
    }
    const DPlan pl = dg_plan(epi, p.g[0].rows, p.g[0].n_exp, p.g[0].N, p.g[1].rows, p.g[1].N,
                             sm_count());
    if (pl.stages < 2 || pl.max_items > 0x7fffffff || pl.grid < 1)
        return pl.max_items == 0 ? 0 : (int)cudaErrorInvalidValue;
    p.stages = pl.stages;
    for (int gi = 0; gi < 2; ++gi)
        if (p.g[gi].rows > 0 && !encode_dgroup(p, gi, ptrs + 9 * gi, pl.bm))
            return (int)cudaErrorNotSupported;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (epi) {
        case kEpiSwiGLU: return (int)launch_dgrad<kEpiSwiGLU>(p, pl, s);
        case kEpiGelu: return (int)launch_dgrad<kEpiGelu>(p, pl, s);
        default: return (int)launch_dgrad<kEpiPlain>(p, pl, s);
    }
}

// The plan moe_weight_grad_launch makes for these jobs on the current
// device (dims as the launch takes them): out[0] ring stages, out[1]
// dynamic shared memory bytes, out[2] blocks, out[3] work items (clamped to
// 2^31 - 1).
int moe_weight_grad_plan(const int* dims, int n_jobs, int* out) {
    if (dims == nullptr || n_jobs < 1 || n_jobs > kMaxJobs || out == nullptr)
        return (int)cudaErrorInvalidValue;
    for (int i = 0; i < n_jobs; ++i)
        if (dims[4 * i + 1] < 1 || dims[4 * i + 2] < 1 || dims[4 * i + 3] < 1)
            return (int)cudaErrorInvalidValue;
    const WPlan pl = wg_plan(dims, n_jobs, sm_count());
    out[0] = pl.stages;
    out[1] = pl.smem;
    out[2] = pl.grid;
    out[3] = (int)(pl.items < 0x7fffffff ? pl.items : 0x7fffffff);
    return 0;
}

// One launch of up to 6 weight gradients: job i is ptrs[4 i ..] = (a (rows,
// M), b (rows, N), out (n_exp, M, N), offsets (n_exp + 1,) int32 or null)
// and dims[4 i ..] = (rows, n_exp, M, N); out[e] = a[seg e]^T b[seg e],
// expert e's rows [offsets[e], offsets[e + 1]) (all rows without offsets,
// n_exp 1).  bf16, 16-byte aligned, M and N multiples of 8.  Returns a
// cudaError_t as moe_data_grad_launch does.
int moe_weight_grad_launch(const void* const* ptrs, const int* dims, int n_jobs, void* stream) {
    if (ptrs == nullptr || dims == nullptr || n_jobs < 1 || n_jobs > kMaxJobs)
        return (int)cudaErrorInvalidValue;
    WParams p;
    memset(&p, 0, sizeof(p));
    p.n_jobs = n_jobs;
    int64_t items = 0;
    for (int i = 0; i < n_jobs; ++i) {
        WJob& j = p.job[i];
        const void* a = ptrs[4 * i];
        const void* b = ptrs[4 * i + 1];
        const void* out = ptrs[4 * i + 2];
        j.offsets = static_cast<const int*>(ptrs[4 * i + 3]);
        j.rows = dims[4 * i];
        j.n_exp = dims[4 * i + 1];
        j.M = dims[4 * i + 2];
        j.N = dims[4 * i + 3];
        if (j.rows < 0 || j.n_exp < 1 || j.M < 8 || j.M % 8 || j.N < 8 || j.N % 8 ||
            (j.offsets == nullptr && j.n_exp != 1) || out == nullptr ||
            (j.rows > 0 && (a == nullptr || b == nullptr)) || misaligned(a) || misaligned(b) ||
            misaligned(out))
            return (int)cudaErrorInvalidValue;
        j.tm = cdiv(j.M, kBN);
        j.tn = cdiv(j.N, kWgBN);
        j.first = (int)items;
        items += (int64_t)j.n_exp * j.tm * j.tn;
        if (items > 0x7fffffff) return (int)cudaErrorInvalidValue;
    }
    const WPlan pl = wg_plan(dims, n_jobs, sm_count());
    if (pl.stages < 2 || pl.grid < 1) return (int)cudaErrorInvalidValue;
    p.n_items = (int)items;
    p.stages = pl.stages;
    for (int i = 0; i < n_jobs; ++i)
        if (!encode_wjob(p, i, ptrs[4 * i], ptrs[4 * i + 1], ptrs[4 * i + 2]))
            return (int)cudaErrorNotSupported;
    cudaError_t err = cudaFuncSetAttribute(moe_weight_grad_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, pl.smem);
    if (err != cudaSuccess) return (int)err;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    moe_weight_grad_kernel<<<pl.grid, 384, pl.smem, s>>>(p);
    return (int)cudaGetLastError();
}

// The route backward's shape for (T, D, E, k): out[0] token tiles of the
// dx launch, out[1] its columns a chunk, out[2] its dynamic shared memory
// bytes, out[3] workspace bytes (clamped to 2^31 - 1), out[4] the dw
// launch's D tiles, out[5] its columns a tile, out[6] its token splits,
// out[7] its tokens a split, out[8] its threads a block, out[9] its
// dynamic shared memory bytes.  T >= 1, D even and at most 4096, 1 <= k <=
// E <= 128, k <= 32.
int moe_route_backward_plan(int T, int D, int E, int k, int* out) {
    if (T < 1 || D < 2 || D % 2 || D > kRbMaxD || E < 1 || E > kRbMaxE || k < 1 || k > E ||
        k > kRbMaxK || out == nullptr)
        return (int)cudaErrorInvalidValue;
    const RbShape s = rb_shape(T, D, E);
    out[0] = s.n_tok_tiles;
    out[1] = s.dc;
    out[2] = s.dx_smem;
    out[3] = (int)(s.ws_bytes < 0x7fffffff ? s.ws_bytes : 0x7fffffff);
    out[4] = s.n_dt;
    out[5] = s.dt;
    out[6] = s.splits;
    out[7] = s.split;
    out[8] = s.wthreads;
    out[9] = s.dw_smem;
    return 0;
}

// The route backward, two launches (see moe_route_backward_dx_kernel and
// moe_route_backward_dw_kernel): x (T, D) bf16, w (D, E) fp32, gates (T, E)
// fp32, weights (T, k) fp32, idx (T, k) int32, dweights (T, k) fp32,
// dgates (T, E) fp32 or null -> dx (T, D) bf16, dw (D, E) fp32.  workspace
// holds moe_route_backward_plan's bytes (16-byte aligned): the dlogits and
// the dw launch's split partials; counters, kRbCounters int32 zeros on the
// device, are left zero by every launch that completes (launches sharing
// them must not overlap).
int moe_route_backward_launch(const void* x, const void* w, const void* gates,
                              const void* weights, const void* idx, const void* dweights,
                              const void* dgates, void* dx, void* dw, void* workspace,
                              void* counters, int T, int D, int E, int k, void* stream) {
    if (T < 1 || D < 2 || D % 2 || D > kRbMaxD || E < 1 || E > kRbMaxE || k < 1 || k > E ||
        k > kRbMaxK || counters == nullptr || workspace == nullptr || misaligned(workspace) ||
        (reinterpret_cast<uintptr_t>(x) & 3))
        return (int)cudaErrorInvalidValue;
    RbParams p;
    p.s = rb_shape(T, D, E);
    if (p.s.n_dt > kRbCounters || p.s.dx_smem > kSmemLimit || p.s.dw_smem > kSmemLimit - 1024)
        return (int)cudaErrorInvalidValue;
    p.x = static_cast<const __nv_bfloat16*>(x);
    p.w = static_cast<const float*>(w);
    p.gates = static_cast<const float*>(gates);
    p.weights = static_cast<const float*>(weights);
    p.idx = static_cast<const int*>(idx);
    p.dweights = static_cast<const float*>(dweights);
    p.dgates = static_cast<const float*>(dgates);
    p.dx = static_cast<__nv_bfloat16*>(dx);
    p.dw = static_cast<float*>(dw);
    p.dl = static_cast<float*>(workspace);
    p.part = static_cast<float*>(workspace) + p.s.dl_floats;
    p.counters = static_cast<int*>(counters);
    p.T = T;
    p.D = D;
    p.E = E;
    p.k = k;
    p.x_vec = D % 8 == 0 && !misaligned(x);
    p.dl_vec = E % 4 == 0;
    p.w_vec = E % 4 == 0 && !misaligned(w);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    return (int)(p.s.ci == 8 ? launch_route_backward<8>(p, st) : launch_route_backward<4>(p, st));
}

const char* moe_backward_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
