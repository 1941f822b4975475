// K1 and K3: the BiLSTM recurrence, both directions in one launch.
//
// K1 replaces the Pallas TPU kernel `lstm_scan_pallas_flat`
// (shufflingvideosfortsg_tpu/ops/pallas/lstm_scan.py:303, body
// `_lstm_kernel_flat` at :159); K3 replaces the train forward
// `lstm_scan_pallas_train_flat` (:970, body `_lstm_kernel_train_flat` at
// :663), which is K1 plus a cell-state residual for the backward kernel.
// One kernel serves both: K3 passes a `c_seq` pointer, K1 passes null.
// The contract:
//   xw   [T, B, 8H] f32  row t = [fwd projection(t) | bwd projection(t)];
//                        the backward half is NOT time-reversed, the kernel
//                        reads it backwards (backward step k uses row T-1-k)
//   w_hh [2, H, 4H] f32  per direction, gate columns in order i, f, g, o
//   out  [T, B, 2H] f32  row t = [h_fwd(t) | h_bwd(t)], natural time order
//   h_T, c_T [2, B, H]   final states, zero initial state
//   c_seq [T, 2, B, H] f32 (K3 only) indexed by STEP s, not by time:
//                        c_seq[s] = [c_fwd(t=s) | c_bwd(step s, time T-1-s)],
//                        the order in which K4 (csrc/lstm_bwd.cu) walks it
//
// What bounds it on an H100. Per layer the recurrence does 2*T*2*B*H*4H
// multiply-adds (4.3 GFLOP at T=128, B=32, H=256: 64 us at the 67 TFLOP/s
// f32 peak) against ~44 MB of traffic (13 us at 3.35 TB/s), so it is bound
// by operations; and the T steps are serially dependent, which adds a
// latency floor of one grid-wide exchange of h per step that no roofline
// counts. W_hh is 2 MiB in f32, far beyond one block's 227 KB of shared
// memory, and h_t needs all of h_{t-1}.
//
// Design. One persistent cooperative launch runs all T steps, as the TPU
// kernel does. The grid is (direction, slice of J hidden units): 2*H/J
// blocks. Each block keeps W_hh[d][:, the 4 gate columns of its J units] in
// shared memory for the whole run (H*J*16 bytes, 32 KB at H=256), so W_hh is
// read from device memory once. A unit's cell state depends only on that
// unit's four gates, so c never leaves the block. Only h is exchanged: each
// step a block stages h_{t-1}[d] (B*H floats, through L2) into shared
// memory, computes the 4*J gates for every batch row, writes its J units of
// h_t to a global buffer double-buffered by step parity, and then all blocks
// meet at a grid-wide barrier. The barrier is an arrival counter; the launch
// is cooperative, so it fails instead of deadlocking when the blocks cannot
// all be resident. One thread owns one (batch row, unit) pair and computes
// its four gates as four length-H dot products from shared memory, reading
// h and W as float4. K3 adds one store of c per (step, row, unit): T*2*B*H
// floats (16.8 MB at T=128, B=64, H=256), which no step waits for.

#include <cuda_runtime.h>
#include <math.h>

#include "common.cuh"

namespace {

using svtsg::grid_barrier;
using svtsg::sigmoid;

constexpr int kUnits = 8;      // J: hidden units per block
constexpr int kThreads = 256;  // threads per block

__global__ void __launch_bounds__(kThreads)
lstm_flat_kernel(const float* __restrict__ xw, const float* __restrict__ w_hh,
                 float* __restrict__ out, float* __restrict__ h_T,
                 float* __restrict__ c_T, float* __restrict__ c_seq,
                 float* h_buf, unsigned int* barrier, int T, int B, int H) {
    extern __shared__ float4 smem4[];
    const int slices = H / kUnits;
    const int d = blockIdx.x / slices;                 // direction
    const int u0 = (blockIdx.x % slices) * kUnits;     // first unit
    const int H4 = 4 * H;
    const int HP = H + 4;  // padded h row: 16-byte aligned, conflict-free
    const int BH = B * H;

    float4* w_s = smem4;                                       // [H][J]
    float* h_s = reinterpret_cast<float*>(smem4 + H * kUnits);  // [B][HP]
    float* c_s = h_s + B * HP;                                 // [B][J]

    // W_hh[d][k][g*H + u0 + u] for g = i, f, g, o -> one float4 per (k, u)
    const float* w = w_hh + (size_t)d * H * H4;
    for (int e = threadIdx.x; e < H * kUnits; e += blockDim.x) {
        const int k = e / kUnits, u = e % kUnits;
        const float* row = w + (size_t)k * H4 + u0 + u;
        w_s[e] = make_float4(row[0], row[H], row[2 * H], row[3 * H]);
    }
    for (int e = threadIdx.x; e < B * kUnits; e += blockDim.x) c_s[e] = 0.0f;

    const int H_4 = H / 4;
    for (int s = 0; s < T; ++s) {
        const int t = d == 0 ? s : T - 1 - s;
        // stage h_{s-1} of this direction (zero before the first step)
        const float4* src = reinterpret_cast<const float4*>(
            h_buf + ((size_t)(s & 1) * 2 + d) * BH);
        for (int e = threadIdx.x; e < B * H_4; e += blockDim.x) {
            const int b = e / H_4, k4 = e % H_4;
            const float4 v = s == 0 ? make_float4(0.f, 0.f, 0.f, 0.f)
                                    : __ldcg(src + e);  // bypass L1
            *reinterpret_cast<float4*>(h_s + b * HP + 4 * k4) = v;
        }
        __syncthreads();

        const float* xw_t = xw + (size_t)t * B * 8 * H + d * H4;
        float* h_next = h_buf + ((size_t)((s + 1) & 1) * 2 + d) * BH;
        for (int p = threadIdx.x; p < B * kUnits; p += blockDim.x) {
            const int b = p / kUnits, u = p % kUnits, unit = u0 + u;
            const float4* h_row = reinterpret_cast<const float4*>(h_s + b * HP);
            float ai = 0.f, af = 0.f, ag = 0.f, ao = 0.f;
            for (int k4 = 0; k4 < H_4; ++k4) {
                const float4 hv = h_row[k4];
                const float hk[4] = {hv.x, hv.y, hv.z, hv.w};
#pragma unroll
                for (int q = 0; q < 4; ++q) {
                    const float4 wv = w_s[(4 * k4 + q) * kUnits + u];
                    ai = fmaf(hk[q], wv.x, ai);
                    af = fmaf(hk[q], wv.y, af);
                    ag = fmaf(hk[q], wv.z, ag);
                    ao = fmaf(hk[q], wv.w, ao);
                }
            }
            const float* x = xw_t + (size_t)b * 8 * H + unit;
            const float gi = sigmoid(x[0] + ai);
            const float gf = sigmoid(x[H] + af);
            const float gg = tanhf(x[2 * H] + ag);
            const float go = sigmoid(x[3 * H] + ao);
            const float c = gf * c_s[p] + gi * gg;
            const float h = go * tanhf(c);
            c_s[p] = c;
            if (c_seq != nullptr)
                c_seq[(((size_t)s * 2 + d) * B + b) * H + unit] = c;
            h_next[b * H + unit] = h;
            out[((size_t)t * B + b) * 2 * H + d * H + unit] = h;
            if (s == T - 1) {
                h_T[((size_t)d * B + b) * H + unit] = h;
                c_T[((size_t)d * B + b) * H + unit] = c;
            }
        }
        if (s + 1 < T) grid_barrier(barrier, (unsigned int)(s + 1) * gridDim.x);
    }
}

}  // namespace

extern "C" {

// Dynamic shared memory one block of the recurrence needs, in bytes.
int svtsg_lstm_smem_bytes(int B, int H) {
    return H * kUnits * 16 + B * (H + 4) * 4 + B * kUnits * 4;
}

// Launch the recurrence on `stream`. c_seq is the [T, 2, B, H] residual
// (K3) or null (K1). h_buf is [2, 2, B, H] f32 scratch and barrier one
// 32-bit word of scratch; both come from the caller. Returns the CUDA error
// code (0 on success).
int svtsg_lstm_recurrence(const float* xw, const float* w_hh, float* out,
                          float* h_T, float* c_T, float* c_seq, float* h_buf,
                          unsigned int* barrier, int T, int B, int H,
                          int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return err;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int smem = svtsg_lstm_smem_bytes(B, H);
    err = cudaFuncSetAttribute(lstm_flat_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return err;
    err = cudaMemsetAsync(barrier, 0, sizeof(unsigned int), st);
    if (err != cudaSuccess) return err;
    void* args[] = {(void*)&xw, (void*)&w_hh, (void*)&out, (void*)&h_T,
                    (void*)&c_T, (void*)&c_seq, (void*)&h_buf, (void*)&barrier,
                    (void*)&T, (void*)&B, (void*)&H};
    const dim3 grid(2 * H / kUnits), block(kThreads);
    err = cudaLaunchCooperativeKernel((const void*)lstm_flat_kernel, grid,
                                      block, args, smem, st);
    if (err != cudaSuccess) return err;
    return cudaGetLastError();
}

const char* svtsg_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
