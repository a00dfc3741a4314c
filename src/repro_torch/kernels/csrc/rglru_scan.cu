// RG-LRU diagonal linear recurrence for Hopper (sm_90a), bound through a plain C
// interface and loaded with ctypes (repro_torch/kernels/rglru_scan/kernel.py).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/rglru_scan/kernel.py::rglru_scan_kernel
// (body _rglru_kernel).  Same contract: a, b (B, L, W) -> h (B, L, W) with
// h_t = a_t * h_{t-1} + b_t per channel from a zero state, fp32 arithmetic,
// output in the input dtype (float32 or bfloat16).
//
// Exactness: each step is __fadd_rn(__fmul_rn(a, h), b).  The intrinsics are
// never contracted into an FMA, so every rounding is the one of the plain left
// fold (a * h, then + b): the fp32 kernel is bitwise the plain PyTorch fold and
// bitwise a sequence of S=1 steps that fold a state in, at every L.  For the
// same reason the sequence is never split over L: a second pass that carried
// each segment's state into the next would reassociate the sum
// (a_t...a_s h_s + ..., rounded in another order), so the one lever the
// recurrence leaves is the time each step waits.  The TPU kernel's closed
// form over a (Q, Q) tile (cumsum of log a turned into one MXU product per
// tile) is ruled out by the same rule.
//
// Design: one warp per block, one channel per lane, 32 channels a block
// (80 blocks at recurrentgemma-2b's W = 2560 and B = 1; blocks of 128
// channels would leave 20, a sixth of the SMs).  The warp streams its
// (L, 32) columns of a and b through a ring of 4 shared-memory stages of
// 32 steps each, by 16-byte cp.async: while it folds stage s, the copies
// of stages s+1 .. s+3 (up to 96 steps ahead) are in flight, so the
// dependent chain of a step is one multiply and one add on values already
// in shared memory.  Each step's h
// is stored at once (one coalesced 128-byte row a warp in fp32); stores do
// not stall the fold.  Calls shorter than one stage (L < 32: decode, and
// short chunks, where there is nothing to prefetch) and shapes whose rows
// are not whole 16-byte chunks (W * sizeof(T) not a multiple of 16, or
// unaligned pointers) take a direct kernel of the same arithmetic: one
// thread per channel, 128 a block, each step loaded from global memory.
//
// Bound on the H100 (80 GB HBM3, 3.35 TB/s): bytes.  Each element reads a and b
// and writes h once (12 bytes in fp32, 6 in bf16) for 2 flops: 7.9 MB, 2.35
// us, for a 256-token chunk at W = 2560.  The fold itself is 256 dependent
// multiply-add pairs (about 8 cycles each, ~1.1 us at 1.8 GHz) after the
// first stage's latency.
//
// Reverse mode (the backward's adjoint; no TPU kernel stands behind it:
// the JAX package differentiates its scan through XLA).  With reverse = 1
// the same kernels fold g = b from the end: dh_t = a_{t+1} dh_{t+1} + g_t
// from dh_L = 0 with a_L = 0, t from L - 1 down to 0, reading a one step
// ahead in place.  A stage of the ring holds the steps t_hi - 1 down to
// t_hi - 32 in that order (row r: g_{t_hi-1-r} beside a_{t_hi-r}, a_L
// stored as zero), so the fold walks its rows as the forward does.  The
// same two roundings a step make it bitwise the plain reverse fold
// (kernels/rglru_scan/ref.py::rglru_scan_backward_plain), with no copy,
// flip or concatenation of a or g around the launch.  Bound: the same
// bytes as the forward (a, g read once, dh written once).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 32;          // channels a block (one warp)
constexpr int kSteps = 32;          // steps a stage
constexpr int kStages = 4;          // ring depth: up to 3 stages in flight
constexpr int kDirectThreads = 128;

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

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
    const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Staged kernel: W * sizeof(T) a multiple of 16 and a, b 16-byte aligned.
template <typename T, bool REV>
__global__ void __launch_bounds__(kLanes) rglru_scan_staged(
    const T* __restrict__ a, const T* __restrict__ b, T* __restrict__ h, int L, int W) {
    constexpr int kElems = 16 / sizeof(T);                // elements a 16-byte chunk
    constexpr int kRowChunks = kLanes / kElems;           // chunks a stage row
    __shared__ __align__(16) T sa[kStages][kSteps][kLanes];
    __shared__ __align__(16) T sb[kStages][kSteps][kLanes];

    const int lane = threadIdx.x;
    const int w0 = blockIdx.x * kLanes;
    const int64_t base = (int64_t)blockIdx.y * L * W + w0;
    const int n_stages = (L + kSteps - 1) / kSteps;

    // copy the s-th stage's steps of the block's columns into ring slot
    // s % kStages, row r holding step t0 + r (reverse: step L - 1 - t0 - r
    // of b beside the next step of a, zero past the end); chunks past W or
    // steps outside [0, L) are not copied
    auto issue = [&](int s) {
        const int slot = s % kStages, t0 = s * kSteps;
        for (int i = lane; i < kSteps * kRowChunks; i += kLanes) {
            const int r = i / kRowChunks, c = (i - r * kRowChunks) * kElems;
            if (t0 + r < L && w0 + c < W) {
                const int t = REV ? L - 1 - t0 - r : t0 + r;
                const int64_t off = base + (int64_t)t * W + c;
                cp_async16(&sb[slot][r][c], b + off);
                if (!REV) {
                    cp_async16(&sa[slot][r][c], a + off);
                } else if (t + 1 < L) {
                    cp_async16(&sa[slot][r][c], a + off + W);
                } else {
#pragma unroll
                    for (int e = 0; e < kElems; ++e) sa[slot][r][c + e] = from_float<T>(0.f);
                }
            }
        }
    };

#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) {
        if (s < n_stages) issue(s);
        cp_async_commit();
    }
    const bool live = w0 + lane < W;
    float hv = 0.f;
    for (int s = 0; s < n_stages; ++s) {
        cp_async_wait<kStages - 2>();   // stage s has landed (this lane's copies)
        __syncwarp();                   // ... and every lane's; slot s - 1 is free
        if (s + kStages - 1 < n_stages) issue(s + kStages - 1);
        cp_async_commit();
        const int slot = s % kStages, t0 = s * kSteps;
        if (live) {
            // row r's output: step t0 + r, or L - 1 - t0 - r in reverse
            T* out = h + base + lane + (int64_t)(REV ? L - 1 - t0 : t0) * W;
            const int64_t step = REV ? -(int64_t)W : (int64_t)W;
            if (t0 + kSteps <= L) {
#pragma unroll
                for (int r = 0; r < kSteps; ++r) {
                    hv = __fadd_rn(__fmul_rn(to_float(sa[slot][r][lane]), hv),
                                   to_float(sb[slot][r][lane]));
                    out[r * step] = from_float<T>(hv);
                }
            } else {
                for (int r = 0; r < L - t0; ++r) {
                    hv = __fadd_rn(__fmul_rn(to_float(sa[slot][r][lane]), hv),
                                   to_float(sb[slot][r][lane]));
                    out[r * step] = from_float<T>(hv);
                }
            }
        }
    }
    cp_async_wait<0>();
}

// Direct kernel: one thread per channel, each step's loads from global
// memory (reverse: t from L - 1 down, a read one step ahead, a_L = 0).
template <typename T, bool REV>
__global__ void __launch_bounds__(kDirectThreads) rglru_scan_direct(
    const T* __restrict__ a, const T* __restrict__ b, T* __restrict__ h, int L, int W) {
    const int w = blockIdx.x * kDirectThreads + threadIdx.x;
    if (w >= W) return;
    const int64_t base = (int64_t)blockIdx.y * L * W + w;
    float hv = 0.f;
#pragma unroll 4
    for (int i = 0; i < L; ++i) {
        const int t = REV ? L - 1 - i : i;
        const int64_t off = base + (int64_t)t * W;
        const float av = REV ? (t + 1 < L ? to_float(a[off + W]) : 0.f) : to_float(a[off]);
        hv = __fadd_rn(__fmul_rn(av, hv), to_float(b[off]));
        h[off] = from_float<T>(hv);
    }
}

// 1 = the staged kernel, 0 = the direct one: a call of at least one stage
// whose rows are whole 16-byte chunks from 16-byte aligned a and b.
bool use_staged(int elt, int L, int W, const void* a, const void* b) {
    return L >= kSteps && ((int64_t)W * elt) % 16 == 0 &&
           ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b)) & 15) == 0;
}

template <typename T, bool REV>
cudaError_t launch_typed(const void* a, const void* b, void* h, int B, int L, int W,
                         cudaStream_t stream) {
    if (use_staged((int)sizeof(T), L, W, a, b)) {
        const dim3 grid((W + kLanes - 1) / kLanes, B);
        rglru_scan_staged<T, REV><<<grid, kLanes, 0, stream>>>(
            static_cast<const T*>(a), static_cast<const T*>(b), static_cast<T*>(h), L, W);
    } else {
        const dim3 grid((W + kDirectThreads - 1) / kDirectThreads, B);
        rglru_scan_direct<T, REV><<<grid, kDirectThreads, 0, stream>>>(
            static_cast<const T*>(a), static_cast<const T*>(b), static_cast<T*>(h), L, W);
    }
    return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (a, b and h share it).  reverse: 0 for
// the scan h_t = a_t h_{t-1} + b_t, 1 for the reverse fold h_t = a_{t+1}
// h_{t+1} + b_t from the end (a_L = 0).  Returns a cudaError_t: 0 on
// success, cudaErrorInvalidValue for a dtype or shape the kernel does not
// take.
int rglru_scan_launch(int dtype, int reverse, const void* a, const void* b, void* h, int B,
                      int L, int W, void* stream) {
    if (B < 0 || L < 0 || W < 0 || B > 65535 || (reverse != 0 && reverse != 1))
        return (int)cudaErrorInvalidValue;
    if (B == 0 || L == 0 || W == 0) return 0;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype == 0)
        return (int)(reverse ? launch_typed<float, true>(a, b, h, B, L, W, s)
                             : launch_typed<float, false>(a, b, h, B, L, W, s));
    if (dtype == 1)
        return (int)(reverse ? launch_typed<__nv_bfloat16, true>(a, b, h, B, L, W, s)
                             : launch_typed<__nv_bfloat16, false>(a, b, h, B, L, W, s));
    return (int)cudaErrorInvalidValue;
}

// The kernel rglru_scan_launch runs for these arguments (either direction):
// 1 = staged, 0 = direct, -1 for a dtype it does not take.  The wrapper counts launches by
// it, so the rule lives here only.
int rglru_scan_kernel_of(int dtype, int L, int W, const void* a, const void* b) {
    if (dtype != 0 && dtype != 1) return -1;
    return use_staged(dtype == 0 ? 4 : 2, L, W, a, b) ? 1 : 0;
}

const char* rglru_scan_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
