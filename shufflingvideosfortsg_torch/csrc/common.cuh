// Device helpers shared by the recurrence kernels (lstm_scan.cu, lstm_bwd.cu):
// types and rounding, the layouts, the cluster partition, the staging copies
// and the register-tiled gate product.
#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace svtsg {

__device__ __forceinline__ float sigmoid(float x) {
    return 1.0f / (1.0f + expf(-x));
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

// Four consecutive elements as loaded (p is 4-element aligned), and as
// floats. A load that is to overlap with arithmetic keeps the raw value in
// its registers and widens it after the arithmetic: a conversion placed
// right behind the load would wait for it.
template <typename T> struct Raw4;
template <> struct Raw4<float> { float4 v; };
template <> struct Raw4<bf16> { uint2 v; };
template <typename T> __device__ __forceinline__ Raw4<T> load_raw4(const T* p) {
    return {*reinterpret_cast<const decltype(Raw4<T>::v)*>(p)};
}
__device__ __forceinline__ float4 widen4(Raw4<float> r) { return r.v; }
__device__ __forceinline__ float4 widen4(Raw4<bf16> r) {
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&r.v.x));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&r.v.y));
    return make_float4(a.x, a.y, b.x, b.y);
}
template <typename T> __device__ __forceinline__ float4 load4(const T* p) {
    return widen4(load_raw4(p));
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


// --- the partition shared by the forward and backward recurrences -----------
//
// A thread-block cluster of kClusterBlocks blocks owns one direction and one
// slice of the batch rows; block `rank` of it owns the H / kClusterBlocks
// hidden units [rank * UB, (rank + 1) * UB) and keeps the four gate columns
// of W_hh for them in shared memory as one float4 (i, f, g, o) per (k, unit).
// Clusters never talk to each other: the recurrence is independent by row.

constexpr int kClusterBlocks = 8;  // the portable maximum
constexpr int kThreads = 256;      // threads per block: kSplits warps
constexpr int kSplits = 8;         // warps; warp w takes k in [w*UB, (w+1)*UB)
constexpr int kTile = 10;          // most batch rows of one register tile

// The width at which a thread keeps its W values in registers (every cfg of
// the repo): H / kSplits = 32 k a warp and 32 units a block, one a lane.
constexpr int kRegH = 256;
constexpr int kRegK = kRegH / kSplits;

// Rows [b0, b0 + rows) of slice i when B rows are cut into n near-equal
// slices, the first B % n one row longer (ops/lstm_scan.py plans the same).
__host__ __device__ inline void slice_rows(int B, int n, int i, int& b0,
                                           int& rows) {
    const int base = B / n, extra = B % n;
    b0 = i * base + (i < extra ? i : extra);
    rows = base + (i < extra ? 1 : 0);
}

__host__ __device__ inline int align16(int bytes) { return (bytes + 15) & ~15; }

// Row stride of the W slice in float4: odd, so that a warp reading one k for
// 32 units and a warp reading one unit for 32 k both spread over all banks.
__host__ __device__ inline int w_stride(int UB) { return UB | 1; }

__device__ __forceinline__ unsigned cluster_rank() {
    return cooperative_groups::this_cluster().block_rank();
}

// The address of `p`, a pointer into this block's shared memory, in block
// `rank` of the cluster (distributed shared memory).
template <typename T>
__device__ __forceinline__ T* remote_shared(T* p, unsigned rank) {
    return cooperative_groups::this_cluster().map_shared_rank(p, rank);
}

// The cluster barrier in two halves: what a thread wrote (also into other
// blocks' shared memory) before arrive is visible to every thread of the
// cluster after its wait. Both halves are also barriers of the block.
__device__ __forceinline__ void cluster_arrive() {
    asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
    asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

__device__ __forceinline__ void cluster_sync() {
    cluster_arrive();
    cluster_wait();
}

// The launch configuration of a recurrence kernel: 2 * n_slices clusters of
// kClusterBlocks blocks of kThreads threads.
struct ClusterLaunch {
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr;
    ClusterLaunch(int n_slices, int smem, cudaStream_t st) : cfg{}, attr{} {
        attr.id = cudaLaunchAttributeClusterDimension;
        attr.val.clusterDim.x = kClusterBlocks;
        attr.val.clusterDim.y = 1;
        attr.val.clusterDim.z = 1;
        cfg.gridDim = dim3(2 * n_slices * kClusterBlocks);
        cfg.blockDim = dim3(kThreads);
        cfg.dynamicSmemBytes = smem;
        cfg.stream = st;
        cfg.attrs = &attr;
        cfg.numAttrs = 1;
    }
};

// The clusters of `kernel` that the card can hold at once with `smem` bytes
// of dynamic shared memory a block (cudaOccupancyMaxActiveClusters), or
// minus the CUDA error code.
template <typename K>
int active_clusters(K kernel, int smem, int device) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return -(int)err;
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return -(int)err;
    ClusterLaunch cl(1, smem, nullptr);
    int n = 0;
    err = cudaOccupancyMaxActiveClusters(&n, kernel, &cl.cfg);
    return err != cudaSuccess ? -(int)err : n;
}

__device__ __forceinline__ void cp_async16(void* dst_shared, const void* src) {
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst_shared);
    const size_t g = __cvta_generic_to_global(src);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(d), "l"(g)
                 : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;" ::: "memory");
}
// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// Copy nseg segments of `seg` elements from device memory (segment i starts
// at src_of(i)) to dst[i * seg] in shared memory, with the whole block. With
// `vec` (segments are whole 16-byte units, 16-byte aligned on both sides)
// the copies are cp.async and land after a later cp_async_wait; otherwise
// they are plain loads and stores.
template <typename T, typename F>
__device__ __forceinline__ void stage_segments(T* dst, int nseg, int seg,
                                               bool vec, F src_of) {
    if (vec) {
        constexpr int kPer = 16 / sizeof(T);
        const int chunks = seg / kPer;
        for (int e = threadIdx.x; e < nseg * chunks; e += blockDim.x) {
            const int i = e / chunks, c = (e % chunks) * kPer;
            cp_async16(dst + i * seg + c, src_of(i) + c);
        }
    } else {
        for (int e = threadIdx.x; e < nseg * seg; e += blockDim.x) {
            const int i = e / seg, c = e % seg;
            dst[i * seg + c] = src_of(i)[c];
        }
    }
}

// Load W_hh[d][:, the gate columns of units u0 .. u0 + UB) into w_s as f32:
// w_s[k * WS + u] = (i, f, g, o) columns of unit u0 + u in row k.
template <typename WT>
__device__ __forceinline__ void load_w_slice(float4* w_s, const WT* w, int H,
                                             int UB, int u0) {
    const int WS = w_stride(UB), H4 = 4 * H;
    for (int e = threadIdx.x; e < H * UB; e += blockDim.x) {
        const int k = e / UB, u = e % UB;
        const WT* row = w + (size_t)k * H4 + u0 + u;
        w_s[k * WS + u] = make_float4(to_f32(row[0]), to_f32(row[H]),
                                      to_f32(row[2 * H]), to_f32(row[3 * H]));
    }
}

// The register-tiled product h @ W_slice for RT batch rows. Lane = unit,
// warp w = the w-th eighth of k (H = kSplits * UB), so one float4 of W
// feeds the RT rows of the tile and one broadcast float4 of h feeds four k
// of all four gates: 16 * RT multiply-adds for 4 + RT shared-memory loads
// (at RT = 5 the loads and the multiply-adds take about the same time, at
// RT = 10 the multiply-adds bound it).
// h points at the tile's first row ([row][HP] floats; rows past the slice
// read whatever follows and their sums are never used). The partial sums
// go to part[(w * RT + row) * UB + unit]; gate_sum adds the kSplits of them
// in a fixed order after a __syncthreads.
template <int RT>
__device__ __forceinline__ void gate_product(const float4* __restrict__ w_s,
                                             const float* __restrict__ h,
                                             float4* __restrict__ part,
                                             int UB, int HP) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int WS = w_stride(UB), k0 = warp * UB;
    for (int u = lane; u < UB; u += 32) {
        float4 acc[RT];
#pragma unroll
        for (int r = 0; r < RT; ++r) acc[r] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (UB % 4 == 0) {
#pragma unroll 2
            for (int k = k0; k < k0 + UB; k += 4) {
                float4 wv[4];
#pragma unroll
                for (int q = 0; q < 4; ++q) wv[q] = w_s[(k + q) * WS + u];
#pragma unroll
                for (int r = 0; r < RT; ++r) {
                    const float4 hv =
                        *reinterpret_cast<const float4*>(h + r * HP + k);
                    const float hk[4] = {hv.x, hv.y, hv.z, hv.w};
#pragma unroll
                    for (int q = 0; q < 4; ++q) {
                        acc[r].x = fmaf(hk[q], wv[q].x, acc[r].x);
                        acc[r].y = fmaf(hk[q], wv[q].y, acc[r].y);
                        acc[r].z = fmaf(hk[q], wv[q].z, acc[r].z);
                        acc[r].w = fmaf(hk[q], wv[q].w, acc[r].w);
                    }
                }
            }
        } else {
            for (int k = k0; k < k0 + UB; ++k) {
                const float4 wv = w_s[k * WS + u];
#pragma unroll
                for (int r = 0; r < RT; ++r) {
                    const float hk = h[r * HP + k];
                    acc[r].x = fmaf(hk, wv.x, acc[r].x);
                    acc[r].y = fmaf(hk, wv.y, acc[r].y);
                    acc[r].z = fmaf(hk, wv.z, acc[r].z);
                    acc[r].w = fmaf(hk, wv.w, acc[r].w);
                }
            }
        }
#pragma unroll
        for (int r = 0; r < RT; ++r) part[(warp * RT + r) * UB + u] = acc[r];
    }
}

// The same product with the thread's W values in registers: w[k] is the
// float4 of (row k0 + k of the slice, this lane's unit), k0 = warp * KW,
// loaded once for the whole run, so the step's only shared-memory loads
// are the broadcast float4 of h. For a width known at compile time
// (KW = H / kSplits k a warp, and as many units a block: one a lane).
template <int RT, int KW>
__device__ __forceinline__ void gate_product_reg(const float4 (&w)[KW],
                                                 const float* __restrict__ h,
                                                 float4* __restrict__ part,
                                                 int HP) {
    static_assert(KW % 4 == 0 && KW <= 32, "one unit a lane, float4 of h");
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    if (lane >= KW) return;
    float4 acc[RT];
#pragma unroll
    for (int r = 0; r < RT; ++r) acc[r] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int k = 0; k < KW; k += 4) {
#pragma unroll
        for (int r = 0; r < RT; ++r) {
            const float4 hv = *reinterpret_cast<const float4*>(
                h + r * HP + warp * KW + k);
            const float hk[4] = {hv.x, hv.y, hv.z, hv.w};
#pragma unroll
            for (int q = 0; q < 4; ++q) {
                acc[r].x = fmaf(hk[q], w[k + q].x, acc[r].x);
                acc[r].y = fmaf(hk[q], w[k + q].y, acc[r].y);
                acc[r].z = fmaf(hk[q], w[k + q].z, acc[r].z);
                acc[r].w = fmaf(hk[q], w[k + q].w, acc[r].w);
            }
        }
    }
#pragma unroll
    for (int r = 0; r < RT; ++r) part[(warp * RT + r) * KW + lane] = acc[r];
}

// The register tile for `rows` rows: kTile, or half of it for few rows.
__host__ __device__ inline int tile_rows(int rows) {
    return rows > kTile / 2 ? kTile : kTile / 2;
}

__device__ __forceinline__ void gate_product_rows(const float4* w_s,
                                                  const float* h, float4* part,
                                                  int rows, int UB, int HP) {
    if (tile_rows(rows) == kTile)
        gate_product<kTile>(w_s, h, part, UB, HP);
    else
        gate_product<kTile / 2>(w_s, h, part, UB, HP);
}

// Sum of the kSplits partial sums of (tile row r, unit u) of a tile of rt
// rows, in warp order.
__device__ __forceinline__ float4 gate_sum(const float4* part, int rt, int r,
                                           int u, int UB) {
    float4 a = part[r * UB + u];
#pragma unroll
    for (int w = 1; w < kSplits; ++w) {
        const float4 v = part[(w * rt + r) * UB + u];
        a.x += v.x;
        a.y += v.y;
        a.z += v.z;
        a.w += v.w;
    }
    return a;
}

}  // namespace svtsg
