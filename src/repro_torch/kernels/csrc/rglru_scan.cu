// RG-LRU diagonal linear recurrence for Hopper (sm_90a), bound through a plain C
// interface and loaded with ctypes (repro_torch/kernels/rglru_scan/kernel.py).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/rglru_scan/kernel.py::rglru_scan_kernel
// (body _rglru_kernel).  Same contract: a, b (B, L, W) -> h (B, L, W) with
// h_t = a_t * h_{t-1} + b_t per channel from a zero state, fp32 arithmetic,
// output in the input dtype (float32 or bfloat16).
//
// Design: one thread per (b, w) channel.  The thread walks t = 0 .. L-1 with
// its running h in a register, so the recurrence carries nothing across
// threads or blocks.  Consecutive threads own consecutive w, so each step's
// loads of a and b and the store of h are coalesced across the warp.  The
// TPU kernel's closed form over a (Q, Q) tile (cumsum of log a turned into one
// MXU product per tile, the carry in VMEM across a sequential grid axis) buys
// nothing here: the card has no sequential grid axis, and the closed form
// reassociates the sum.
//
// Exactness: each step is __fadd_rn(__fmul_rn(a, h), b).  The intrinsics are
// never contracted into an FMA, so every rounding is the one of the plain left
// fold (a * h, then + b): the fp32 kernel is bitwise the plain PyTorch fold and
// bitwise a sequence of S=1 steps that fold a state in, at every L.
//
// Bound on the H100 (80 GB HBM3, 3.35 TB/s): bytes.  Each element reads a and b
// and writes h once (12 bytes in fp32, 6 in bf16) for 2 flops.  At the
// serving shapes of recurrentgemma-2b (W = 2560) the grid is ceil(W / 128) x B
// blocks: 20 blocks at B = 1 on 132 SMs, so one chunk of prefill keeps a
// sixth of the card busy and each warp waits on its loads one step at a time.
// A split over L that keeps the left-fold order (a second pass that carries
// each segment's state) is the lever for later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

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

template <typename T>
__global__ void __launch_bounds__(kThreads) rglru_scan_kernel(
    const T* __restrict__ a, const T* __restrict__ b, T* __restrict__ h, int L, int W) {
    const int w = blockIdx.x * kThreads + threadIdx.x;
    if (w >= W) return;
    const int64_t base = (int64_t)blockIdx.y * L * W + w;
    float hv = 0.f;
#pragma unroll 4
    for (int t = 0; t < L; ++t) {
        const int64_t off = base + (int64_t)t * W;
        hv = __fadd_rn(__fmul_rn(to_float(a[off]), hv), to_float(b[off]));
        h[off] = from_float<T>(hv);
    }
}

template <typename T>
cudaError_t launch_typed(const void* a, const void* b, void* h, int B, int L, int W,
                         cudaStream_t stream) {
    const dim3 grid((W + kThreads - 1) / kThreads, B);
    rglru_scan_kernel<T><<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(a), static_cast<const T*>(b), static_cast<T*>(h), L, W);
    return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (a, b and h share it).  Returns a
// cudaError_t: 0 on success, cudaErrorInvalidValue for a dtype or shape the
// kernel does not take.
int rglru_scan_launch(int dtype, const void* a, const void* b, void* h, int B, int L, int W,
                      void* stream) {
    if (B < 0 || L < 0 || W < 0 || B > 65535) return (int)cudaErrorInvalidValue;
    if (B == 0 || L == 0 || W == 0) return 0;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype == 0) return (int)launch_typed<float>(a, b, h, B, L, W, s);
    if (dtype == 1) return (int)launch_typed<__nv_bfloat16>(a, b, h, B, L, W, s);
    return (int)cudaErrorInvalidValue;
}

const char* rglru_scan_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
