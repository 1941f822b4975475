// Device helpers shared by the recurrence kernels (lstm_scan.cu, lstm_bwd.cu).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace svtsg {

__device__ __forceinline__ float sigmoid(float x) {
    return 1.0f / (1.0f + expf(-x));
}

// Grid-wide barrier over a monotone arrival counter: the n-th barrier
// returns once the counter reaches n * gridDim.x. Every thread fences its
// own writes first, so what a block wrote before the barrier is visible to
// every block that passes it (readers load such data with __ldcg, past L1).
// Only a cooperative launch guarantees that all blocks are resident.
__device__ __forceinline__ void grid_barrier(unsigned int* counter,
                                             unsigned int target) {
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) {
        atomicAdd(counter, 1u);
        volatile unsigned int* seen = counter;
        while (*seen < target) {
            __nanosleep(32);
        }
        __threadfence();
    }
    __syncthreads();
}

// Codes of the C entry points' layout and dtype arguments (the wrappers in
// ops/lstm_scan.py pass the same numbers).
enum Layout : int { kFlat = 0, kStacked = 1 };
enum DType : int { kF32 = 0, kBF16 = 1 };

using bf16 = __nv_bfloat16;

template <typename T> __device__ __forceinline__ float to_f32(T x);
template <> __device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f32<bf16>(bf16 x) {
    return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float x) {
    return __float2bfloat16_rn(x);
}

// x rounded to T and widened back: the cast `a.astype(T)` of the JAX
// kernels at a rounding point (the identity for float).
template <typename T>
__device__ __forceinline__ float round_to(float x) {
    return to_f32<T>(from_f32<T>(x));
}

template <typename T>
__device__ __forceinline__ float4 round_to(float4 v) {
    return make_float4(round_to<T>(v.x), round_to<T>(v.y), round_to<T>(v.z),
                       round_to<T>(v.w));
}

// Four consecutive elements as floats; p is 4-element aligned.
template <typename T> __device__ __forceinline__ float4 load4(const T* p);
template <> __device__ __forceinline__ float4 load4<float>(const float* p) {
    return *reinterpret_cast<const float4*>(p);
}
template <> __device__ __forceinline__ float4 load4<bf16>(const bf16* p) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
    return make_float4(a.x, a.y, b.x, b.y);
}

// Element offset of the 4H gate row of (step s, direction d, batch row b)
// in xw and d_xw, and of the H-wide row in out and d_out. BS is the row
// stride: the whole batch, of which a launch may run a slice of rows.
//   kFlat:    xw [T, BS, 8H], row t = [fwd(t) | bwd(t)], the backward half
//             NOT time-reversed (step s of direction 1 is time T-1-s);
//             out [T, BS, 2H] in natural time order.
//   kStacked: xw [T, 2, BS, 4H] with direction 1 already time-reversed
//             (step s reads xw[s, d]); out [T, 2, BS, H] by step.
template <int L>
__device__ __forceinline__ size_t xw_row(int s, int d, int b, int T, int BS,
                                         int H) {
    if constexpr (L == kFlat) {
        const int t = d == 0 ? s : T - 1 - s;
        return ((size_t)t * BS + b) * 8 * H + (size_t)d * 4 * H;
    } else {
        return (((size_t)s * 2 + d) * BS + b) * 4 * H;
    }
}

template <int L>
__device__ __forceinline__ size_t out_row(int s, int d, int b, int T, int BS,
                                          int H) {
    if constexpr (L == kFlat) {
        const int t = d == 0 ? s : T - 1 - s;
        return ((size_t)t * BS + b) * 2 * H + (size_t)d * H;
    } else {
        return (((size_t)s * 2 + d) * BS + b) * H;
    }
}

}  // namespace svtsg
