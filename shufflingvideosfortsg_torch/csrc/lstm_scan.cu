// K1, K3, K6a and K6b: the BiLSTM recurrence, both directions in one launch.
//
// One kernel template serves four Pallas TPU kernels of
// shufflingvideosfortsg_tpu/ops/pallas/lstm_scan.py:
//   K1  `lstm_scan_pallas_flat` (:303, body `_lstm_kernel_flat` :159):
//       flat layout, f32;
//   K3  `lstm_scan_pallas_train_flat` (:970, body :663): K1 plus the c_seq
//       residual for the backward kernel;
//   K6a `lstm_scan_pallas` (:549, body `_lstm_kernel` :65): stacked layout,
//       xw/out in f32 or bf16, w_hh in f32 or bf16, `gates_bf16`;
//   K6b `lstm_scan_pallas_train` (:603, body `_lstm_kernel_train` :317):
//       K6a plus c_seq, without `gates_bf16`.
// The contract (layouts in common.cuh):
//   xw   flat [T, B, 8H] or stacked [T, 2, B, 4H], type XT (f32 or bf16):
//        the input projections plus biases, gate columns i, f, g, o
//   w_hh [2, H, 4H] type WT (f32 or bf16); when WT is bf16, h is rounded to
//        bf16 before the product (`h.astype(w_hh.dtype)`), which sums in f32
//   out  flat [T, B, 2H] in natural time order, or stacked [T, 2, B, H] by
//        step (not put back in time order), type XT
//   h_T, c_T [2, B, H] f32   final states, zero initial state; carries f32
//   c_seq [T, 2, B, H] f32 (K3, K6b) indexed by STEP s:
//        c_seq[s] = [c_fwd(t=s) | c_bwd(step s, time T-1-s)], the order in
//        which the backward kernels (csrc/lstm_bwd.cu) walk it
//   GATES_BF16 (K6a only, `lstm_scan.py:120-137`): the f32 pre-activation is
//        rounded to bf16, sigmoid is 1/(1+exp(-v)) and tanh(g) is taken in
//        bf16 with a rounding after each operation, and the gates are
//        widened to f32 for c = f*c + i*g and h = o*tanh(c).
// A launch may run a slice of the batch: rows [b0, b0 + B) of a batch of BS
// rows (ops/lstm_scan.py splits a batch whose rows do not fit one block's
// shared memory into several launches).
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
// shared memory as f32 for the whole run (H*J*16 bytes, 32 KB at H=256), so
// W_hh is read from device memory once. A unit's cell state depends only on
// that unit's four gates, so c never leaves the block. Only h is exchanged:
// each step a block stages h_{t-1}[d] (B*H floats, through L2) into shared
// memory, computes the 4*J gates for every batch row, writes its J units of
// h_t to a global f32 buffer double-buffered by step parity, and then all
// blocks meet at a grid-wide barrier. The barrier is an arrival counter; the
// launch is cooperative, so it fails instead of deadlocking when the blocks
// cannot all be resident. One thread owns one (batch row, unit) pair and
// computes its four gates as four length-H dot products from shared memory,
// reading h and W as float4. bf16 storage changes only the loads, the
// stores and the rounding points; the arithmetic stays f32. K3/K6b add one
// store of c per (step, row, unit): T*2*B*H floats (16.8 MB at T=128, B=64,
// H=256), which no step waits for.

#include <cuda_runtime.h>
#include <math.h>

#include "common.cuh"

namespace {

using namespace svtsg;

constexpr int kUnits = 8;      // J: hidden units per block
constexpr int kThreads = 256;  // threads per block

__device__ __forceinline__ float sigmoid_bf16(float v) {
    // jax: one / (one + jnp.exp(-v)) on bf16 values, rounded after each op
    const float e = round_to<bf16>(expf(-v));
    return round_to<bf16>(1.0f / round_to<bf16>(1.0f + e));
}

template <int L, typename XT, typename WT, bool GATES_BF16>
__global__ void __launch_bounds__(kThreads)
lstm_fwd_kernel(const XT* __restrict__ xw, const WT* __restrict__ w_hh,
                XT* __restrict__ out, float* __restrict__ h_T,
                float* __restrict__ c_T, float* __restrict__ c_seq,
                float* h_buf, unsigned int* barrier, int T, int B, int H,
                int b0, int BS) {
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
    const WT* w = w_hh + (size_t)d * H * H4;
    for (int e = threadIdx.x; e < H * kUnits; e += blockDim.x) {
        const int k = e / kUnits, u = e % kUnits;
        const WT* row = w + (size_t)k * H4 + u0 + u;
        w_s[e] = make_float4(to_f32(row[0]), to_f32(row[H]),
                             to_f32(row[2 * H]), to_f32(row[3 * H]));
    }
    for (int e = threadIdx.x; e < B * kUnits; e += blockDim.x) c_s[e] = 0.0f;

    const int H_4 = H / 4;
    for (int s = 0; s < T; ++s) {
        // stage h_{s-1} of this direction (zero before the first step),
        // rounded to WT as the product takes it
        const float4* src = reinterpret_cast<const float4*>(
            h_buf + ((size_t)(s & 1) * 2 + d) * BH);
        for (int e = threadIdx.x; e < B * H_4; e += blockDim.x) {
            const int b = e / H_4, k4 = e % H_4;
            const float4 v = s == 0 ? make_float4(0.f, 0.f, 0.f, 0.f)
                                    : round_to<WT>(__ldcg(src + e));  // past L1
            *reinterpret_cast<float4*>(h_s + b * HP + 4 * k4) = v;
        }
        __syncthreads();

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
            const XT* x = xw + xw_row<L>(s, d, b0 + b, T, BS, H) + unit;
            const float pi = to_f32(x[0]) + ai, pf = to_f32(x[H]) + af;
            const float pg = to_f32(x[2 * H]) + ag, po = to_f32(x[3 * H]) + ao;
            float gi, gf, gg, go;
            if constexpr (GATES_BF16) {
                gi = sigmoid_bf16(round_to<bf16>(pi));
                gf = sigmoid_bf16(round_to<bf16>(pf));
                gg = round_to<bf16>(tanhf(round_to<bf16>(pg)));
                go = sigmoid_bf16(round_to<bf16>(po));
            } else {
                gi = sigmoid(pi);
                gf = sigmoid(pf);
                gg = tanhf(pg);
                go = sigmoid(po);
            }
            const float c = gf * c_s[p] + gi * gg;
            const float h = go * tanhf(c);
            c_s[p] = c;
            const int row = b0 + b;
            if (c_seq != nullptr)
                c_seq[(((size_t)s * 2 + d) * BS + row) * H + unit] = c;
            h_next[b * H + unit] = h;
            out[out_row<L>(s, d, row, T, BS, H) + unit] = from_f32<XT>(h);
            if (s == T - 1) {
                h_T[((size_t)d * BS + row) * H + unit] = h;
                c_T[((size_t)d * BS + row) * H + unit] = c;
            }
        }
        if (s + 1 < T) grid_barrier(barrier, (unsigned int)(s + 1) * gridDim.x);
    }
}

int smem_bytes(int B, int H) {
    return H * kUnits * 16 + B * (H + 4) * 4 + B * kUnits * 4;
}

struct FwdArgs {
    const void* xw;
    const void* w_hh;
    void* out;
    float* h_T;
    float* c_T;
    float* c_seq;
    float* h_buf;
    unsigned int* barrier;
    int T, B, H, b0, BS;
};

template <int L, typename XT, typename WT, bool GATES_BF16>
cudaError_t launch(FwdArgs a, cudaStream_t st) {
    auto kernel = lstm_fwd_kernel<L, XT, WT, GATES_BF16>;
    const int smem = smem_bytes(a.B, a.H);
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    err = cudaMemsetAsync(a.barrier, 0, sizeof(unsigned int), st);
    if (err != cudaSuccess) return err;
    const XT* xw = static_cast<const XT*>(a.xw);
    const WT* w_hh = static_cast<const WT*>(a.w_hh);
    XT* out = static_cast<XT*>(a.out);
    void* args[] = {(void*)&xw, (void*)&w_hh, (void*)&out, (void*)&a.h_T,
                    (void*)&a.c_T, (void*)&a.c_seq, (void*)&a.h_buf,
                    (void*)&a.barrier, (void*)&a.T, (void*)&a.B, (void*)&a.H,
                    (void*)&a.b0, (void*)&a.BS};
    const dim3 grid(2 * a.H / kUnits), block(kThreads);
    err = cudaLaunchCooperativeKernel((const void*)kernel, grid, block, args,
                                      smem, st);
    if (err != cudaSuccess) return err;
    return cudaGetLastError();
}

template <typename XT, typename WT>
cudaError_t launch_stacked(FwdArgs a, int gates_bf16, cudaStream_t st) {
    return gates_bf16 ? launch<kStacked, XT, WT, true>(a, st)
                      : launch<kStacked, XT, WT, false>(a, st);
}

}  // namespace

extern "C" {

// The most rows one launch of the recurrence takes at width H within
// smem_limit bytes of dynamic shared memory a block (0 when not even one
// row fits).
int svtsg_lstm_max_rows(int H, int smem_limit) {
    int B = 0;
    while (smem_bytes(B + 1, H) <= smem_limit) ++B;
    return B;
}

// Launch the recurrence on `stream` over rows [b0, b0 + B) of a batch of BS
// rows. layout: kFlat (f32 only, no gates_bf16: K1, K3) or kStacked (K6a,
// K6b); xw_dtype / w_dtype: kF32 or kBF16. c_seq is the [T, 2, BS, H]
// residual (K3, K6b) or null (K1, K6a). h_buf is [2, 2, B, H] f32 scratch
// and barrier one 32-bit word of scratch; both come from the caller.
// Returns the CUDA error code (0 on success).
int svtsg_lstm_recurrence(const void* xw, const void* w_hh, void* out,
                          float* h_T, float* c_T, float* c_seq, float* h_buf,
                          unsigned int* barrier, int T, int B, int H, int b0,
                          int BS, int layout, int xw_dtype, int w_dtype,
                          int gates_bf16, int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return err;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const FwdArgs a{xw, w_hh, out, h_T, c_T, c_seq, h_buf, barrier,
                    T, B, H, b0, BS};
    if (layout == kFlat && xw_dtype == kF32 && w_dtype == kF32 && !gates_bf16)
        return launch<kFlat, float, float, false>(a, st);
    if (layout != kStacked) return cudaErrorInvalidValue;
    if (xw_dtype == kF32 && w_dtype == kF32)
        return launch_stacked<float, float>(a, gates_bf16, st);
    if (xw_dtype == kF32 && w_dtype == kBF16)
        return launch_stacked<float, bf16>(a, gates_bf16, st);
    if (xw_dtype == kBF16 && w_dtype == kF32)
        return launch_stacked<bf16, float>(a, gates_bf16, st);
    if (xw_dtype == kBF16 && w_dtype == kBF16)
        return launch_stacked<bf16, bf16>(a, gates_bf16, st);
    return cudaErrorInvalidValue;
}

const char* svtsg_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
