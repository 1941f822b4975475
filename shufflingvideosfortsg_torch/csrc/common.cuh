// Device helpers shared by the recurrence kernels (lstm_scan.cu, lstm_bwd.cu).
#pragma once

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

}  // namespace svtsg
