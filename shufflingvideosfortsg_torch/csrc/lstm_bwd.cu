// K4 and K6c: the BiLSTM backward recurrence, both directions in one launch.
//
// One kernel template serves two Pallas TPU kernels of
// shufflingvideosfortsg_tpu/ops/pallas/lstm_scan.py:
//   K4  `lstm_scan_pallas_bwd_flat` (:1024, body `_lstm_bwd_kernel_flat`
//       :766): flat layout, f32;
//   K6c `lstm_scan_pallas_bwd` (:655, body `_lstm_bwd_kernel` :385, contract
//       :609-660): stacked layout, xw/out/d_out in f32 or bf16, w_hh in f32
//       or bf16.
// The contract (layouts in common.cuh):
//   xw    flat [T, B, 8H] or stacked [T, 2, B, 4H], type XT: the forward's
//         input
//   w_hh  [2, H, 4H] type WT, gate columns i, f, g, o
//   out   the forward's output (flat [T, B, 2H] in time order, stacked
//         [T, 2, B, H] by step), type XT
//   c_seq [T, 2, B, H] f32   the forward's cell states by STEP (K3's, K6b's)
//   d_out like out, type XT; d_hT, d_cT [2, B, H] f32   cotangents
//   -> d_xw in the layout of xw, f32, and d_w_hh [2, H, 4H] f32.
// One reverse loop over the step s = T-1..0 serves both directions. The
// step's rows of xw, d_out and d_xw are at step s (time T-1-s for the flat
// backward lane); h_prev is out at step s-1 (flat backward lane:
// out[T-s, :, H:]), c_prev is c_seq[s-1], and both are zero at s = 0. The
// gates are recomputed from h_prev and xw, not stored. As in the JAX body
// (:444-489), h_prev is cast to WT before the products, the gates are f32,
// and dgates is cast to WT for the dh_prev and d_w_hh products, both summed
// in f32; d_xw holds the f32 dgates. A launch may run rows [b0, b0 + B) of
// a batch of BS rows; with `accumulate` it adds its d_w_hh to what d_w_hh
// holds (the batch's earlier slices, run before on the same stream).
//
// What bounds it on an H100. Per layer it does three products of the
// forward's size: the gate recompute h_prev @ W_hh, dh_prev = dgates @
// W_hh^T and d_w_hh += h_prev^T @ dgates, 3 * 2*T*2*B*H*4H = 25.8 GFLOP at
// T=128, B=64, H=256 (0.385 ms at the 67 TFLOP/s f32 peak), against ~120 MB
// of traffic (36 us at 3.35 TB/s): bound by operations. The T steps are
// serially dependent, and dh_prev needs every gate column of the step:
// one grid-wide exchange per step, which no roofline counts.
//
// Design. One persistent cooperative launch of 2*H/J blocks, as K1: block
// (d, J units) owns the 4*J = 32 gate columns of its units. It keeps in
// shared memory, as f32, W_hh[d][:, own columns] (for the gate recompute),
// the rows W_hh[d][own units, :] (for dh_prev) and d_w_hh[d][:, own
// columns] (the accumulator, written once at the end): 96 KB at H=256. Per
// step each thread owns (batch row, unit) pairs: it recomputes the four
// gates, forms the four dgates from dh, dc, c[s], c[s-1], and writes them
// straight into d_xw, the kernel's output, and into shared memory. The
// block then adds h_prev^T @ dgates to its d_w_hh columns, all blocks meet
// at a grid-wide barrier, and each block reads the step's whole dgates row
// back from d_xw through L2 (__ldcg, in chunks of rows staged over the
// h_prev buffer) to form dh_prev for its own units. dc never leaves the
// block; dh_prev is only needed by the block that owns the unit, so one
// barrier a step suffices and the rows of d_xw, which differ every step,
// need no second buffer.

#include <cuda_runtime.h>
#include <math.h>

#include "common.cuh"

namespace {

using namespace svtsg;

constexpr int kUnits = 8;               // J: hidden units per block
constexpr int kCols = 4 * kUnits;       // gate columns per block (a warp)
constexpr int kThreads = 256;           // threads per block
constexpr int kSplit = 4;               // threads per dh_prev dot product
constexpr int kRowPad = 16;             // pad of a W_hh row: no bank conflicts
constexpr unsigned kFull = 0xffffffffu;

// Rows of dgates staged at once for dh_prev: as many as the h_prev buffer
// holds, at least one.
__host__ __device__ inline int chunk_rows(int B, int H) {
    const int rows = B * (H + 4) / (4 * H);
    return rows < 1 ? 1 : (rows > B ? B : rows);
}

// Floats of the buffer that holds h_prev [B][H+4], then dgates rows [r][4H].
__host__ __device__ inline int stage_floats(int B, int H) {
    const int a = B * (H + 4), b = chunk_rows(B, H) * 4 * H;
    return a > b ? a : b;
}

template <int L, typename XT, typename WT>
__global__ void __launch_bounds__(kThreads)
lstm_bwd_kernel(const XT* __restrict__ xw, const WT* __restrict__ w_hh,
                const XT* __restrict__ out, const float* __restrict__ c_seq,
                const XT* __restrict__ d_out, const float* __restrict__ d_hT,
                const float* __restrict__ d_cT, float* d_xw,
                float* __restrict__ d_w_hh, unsigned int* barrier,
                int T, int B, int H, int b0, int BS, int accumulate) {
    extern __shared__ float4 smem4[];
    const int slices = H / kUnits;
    const int d = blockIdx.x / slices;                 // direction
    const int u0 = (blockIdx.x % slices) * kUnits;     // first unit
    const int H4 = 4 * H, H_4 = H / 4;
    const int HP = H + 4;            // padded h row: 16-byte aligned
    const int WR = H4 + kRowPad;     // padded W_hh row
    const int tid = threadIdx.x;

    float4* w_s = smem4;                                         // [H][J]
    float* w_row = reinterpret_cast<float*>(smem4 + H * kUnits); // [J][WR]
    float* dw_s = w_row + kUnits * WR;                           // [H][kCols]
    float* h_s = dw_s + H * kCols;               // [B][HP], then [r][4H]
    float* dg_s = h_s + stage_floats(B, H);                      // [B][kCols]
    float* dc_s = dg_s + B * kCols;                              // [B][J]
    float* dh_s = dc_s + B * kUnits;                             // [B][J]

    // W_hh[d][k][g*H + u0 + u] for g = i, f, g, o -> one float4 per (k, u)
    const WT* w = w_hh + (size_t)d * H * H4;
    for (int e = tid; e < H * kUnits; e += blockDim.x) {
        const int k = e / kUnits, u = e % kUnits;
        const WT* row = w + (size_t)k * H4 + u0 + u;
        w_s[e] = make_float4(to_f32(row[0]), to_f32(row[H]),
                             to_f32(row[2 * H]), to_f32(row[3 * H]));
    }
    for (int e = tid; e < kUnits * H4; e += blockDim.x) {
        const int u = e / H4, col = e % H4;
        w_row[u * WR + col] = to_f32(w[(size_t)(u0 + u) * H4 + col]);
    }
    for (int e = tid; e < H * kCols; e += blockDim.x) dw_s[e] = 0.0f;
    for (int e = tid; e < B * kUnits; e += blockDim.x) {
        const size_t g =
            ((size_t)d * BS + b0 + e / kUnits) * H + u0 + e % kUnits;
        dc_s[e] = d_cT[g];
        dh_s[e] = d_hT[g];
    }
    __syncthreads();

    const int warp = tid / 32, lane = tid % 32, warps = blockDim.x / 32;
    const int rows_per_chunk = chunk_rows(B, H);
    for (int m = 0; m < T; ++m) {
        const int s = T - 1 - m;
        // stage h_prev of this direction (zero at the first step), cast to
        // WT as the products take it
        if (s > 0) {
            for (int e = tid; e < B * H_4; e += blockDim.x) {
                const int b = e / H_4, k4 = e % H_4;
                const XT* src = out + out_row<L>(s - 1, d, b0 + b, T, BS, H);
                *reinterpret_cast<float4*>(h_s + b * HP + 4 * k4) =
                    round_to<WT>(load4(src + 4 * k4));
            }
        } else {
            for (int e = tid; e < B * HP; e += blockDim.x) h_s[e] = 0.0f;
        }
        __syncthreads();

        const float* c_now = c_seq + ((size_t)s * 2 + d) * BS * H;
        const float* c_before =
            s > 0 ? c_seq + ((size_t)(s - 1) * 2 + d) * BS * H : nullptr;
        for (int p = tid; p < B * kUnits; p += blockDim.x) {
            const int b = p / kUnits, u = p % kUnits, unit = u0 + u;
            const int row = b0 + b;
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
            const size_t xr = xw_row<L>(s, d, row, T, BS, H) + unit;
            const XT* x = xw + xr;
            const float gi = sigmoid(to_f32(x[0]) + ai);
            const float gf = sigmoid(to_f32(x[H]) + af);
            const float gg = tanhf(to_f32(x[2 * H]) + ag);
            const float go = sigmoid(to_f32(x[3 * H]) + ao);
            const size_t bu = (size_t)row * H + unit;
            const float c_t = c_now[bu];
            const float c_p = c_before != nullptr ? c_before[bu] : 0.0f;

            const float dh =
                dh_s[p] + to_f32(d_out[out_row<L>(s, d, row, T, BS, H) + unit]);
            const float tc = tanhf(c_t);
            const float dc = dc_s[p] + dh * go * (1.0f - tc * tc);
            const float dgi = dc * gg * gi * (1.0f - gi);
            const float dgf = dc * c_p * gf * (1.0f - gf);
            const float dgg = dc * gi * (1.0f - gg * gg);
            const float dgo = dh * tc * go * (1.0f - go);
            float* dst = d_xw + xr;
            dst[0] = dgi;
            dst[H] = dgf;
            dst[2 * H] = dgg;
            dst[3 * H] = dgo;
            float* dg = dg_s + b * kCols + u;
            dg[0] = round_to<WT>(dgi);
            dg[kUnits] = round_to<WT>(dgf);
            dg[2 * kUnits] = round_to<WT>(dgg);
            dg[3 * kUnits] = round_to<WT>(dgo);
            dc_s[p] = dc * gf;
        }
        __syncthreads();

        // d_w_hh[:, own columns] += h_prev^T @ dgates (h_prev is 0 at s = 0).
        // A warp takes four rows k at a time, lane = local column.
        if (s > 0) {
            for (int k4 = warp; k4 < H_4; k4 += warps) {
                float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
                for (int b = 0; b < B; ++b) {
                    const float4 hv =
                        *reinterpret_cast<const float4*>(h_s + b * HP + 4 * k4);
                    const float g = dg_s[b * kCols + lane];
                    a0 = fmaf(hv.x, g, a0);
                    a1 = fmaf(hv.y, g, a1);
                    a2 = fmaf(hv.z, g, a2);
                    a3 = fmaf(hv.w, g, a3);
                }
                float* dst = dw_s + 4 * k4 * kCols + lane;
                dst[0] += a0;
                dst[kCols] += a1;
                dst[2 * kCols] += a2;
                dst[3 * kCols] += a3;
            }
        }
        if (m + 1 == T) break;  // the first step's dh_prev is never used
        grid_barrier(barrier, (unsigned int)(m + 1) * gridDim.x);

        // dh_prev[b][u] = sum_col dgates[b][col] * W_hh[d][u0 + u][col] over
        // all 4H columns of the step, read back from d_xw through L2 and
        // cast to WT
        for (int bc = 0; bc < B; bc += rows_per_chunk) {
            const int rows = min(rows_per_chunk, B - bc);
            float4* stage = reinterpret_cast<float4*>(h_s);
            for (int e = tid; e < rows * H; e += blockDim.x) {
                const int r = e / H, c4 = e % H;
                const float* src = d_xw + xw_row<L>(s, d, b0 + bc + r, T, BS, H);
                stage[e] = round_to<WT>(
                    __ldcg(reinterpret_cast<const float4*>(src) + c4));
            }
            __syncthreads();
            // kSplit neighbouring threads share one (row, unit) dot product;
            // rows * J * kSplit is a multiple of 32, so whole warps iterate
            for (int q = tid; q < rows * kUnits * kSplit; q += blockDim.x) {
                const int part = q % kSplit, pr = q / kSplit;
                const int r = pr / kUnits, u = pr % kUnits;
                const float4* gr = stage + r * H;
                const float4* wr = reinterpret_cast<const float4*>(w_row + u * WR);
                float acc = 0.f;
                for (int c4 = part; c4 < H; c4 += kSplit) {
                    const float4 g = gr[c4], wv = wr[c4];
                    acc = fmaf(g.x, wv.x, acc);
                    acc = fmaf(g.y, wv.y, acc);
                    acc = fmaf(g.z, wv.z, acc);
                    acc = fmaf(g.w, wv.w, acc);
                }
                acc += __shfl_xor_sync(kFull, acc, 1);
                acc += __shfl_xor_sync(kFull, acc, 2);
                if (part == 0) dh_s[(bc + r) * kUnits + u] = acc;
            }
            __syncthreads();
        }
    }

    for (int e = tid; e < H * kCols; e += blockDim.x) {
        const int k = e / kCols, lc = e % kCols;
        const int q = lc / kUnits, u = lc % kUnits;
        float* dst = d_w_hh + ((size_t)d * H + k) * H4 + q * H + u0 + u;
        *dst = accumulate ? *dst + dw_s[e] : dw_s[e];
    }
}

int smem_bytes(int B, int H) {
    const int floats = H * kUnits * 4 + kUnits * (4 * H + kRowPad)
                       + H * kCols + stage_floats(B, H) + B * kCols
                       + 2 * B * kUnits;
    return floats * 4;
}

struct BwdArgs {
    const void* xw;
    const void* w_hh;
    const void* out;
    const float* c_seq;
    const void* d_out;
    const float* d_hT;
    const float* d_cT;
    float* d_xw;
    float* d_w_hh;
    unsigned int* barrier;
    int T, B, H, b0, BS, accumulate;
};

template <int L, typename XT, typename WT>
cudaError_t launch(BwdArgs a, cudaStream_t st) {
    auto kernel = lstm_bwd_kernel<L, XT, WT>;
    const int smem = smem_bytes(a.B, a.H);
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    err = cudaMemsetAsync(a.barrier, 0, sizeof(unsigned int), st);
    if (err != cudaSuccess) return err;
    const XT* xw = static_cast<const XT*>(a.xw);
    const WT* w_hh = static_cast<const WT*>(a.w_hh);
    const XT* out = static_cast<const XT*>(a.out);
    const XT* d_out = static_cast<const XT*>(a.d_out);
    void* args[] = {(void*)&xw, (void*)&w_hh, (void*)&out, (void*)&a.c_seq,
                    (void*)&d_out, (void*)&a.d_hT, (void*)&a.d_cT,
                    (void*)&a.d_xw, (void*)&a.d_w_hh, (void*)&a.barrier,
                    (void*)&a.T, (void*)&a.B, (void*)&a.H, (void*)&a.b0,
                    (void*)&a.BS, (void*)&a.accumulate};
    const dim3 grid(2 * a.H / kUnits), block(kThreads);
    err = cudaLaunchCooperativeKernel((const void*)kernel, grid, block, args,
                                      smem, st);
    if (err != cudaSuccess) return err;
    return cudaGetLastError();
}

}  // namespace

extern "C" {

// The most rows one launch of the backward recurrence takes at width H
// within smem_limit bytes of dynamic shared memory a block (0 when not even
// one row fits).
int svtsg_lstm_bwd_max_rows(int H, int smem_limit) {
    int B = 0;
    while (smem_bytes(B + 1, H) <= smem_limit) ++B;
    return B;
}

// Launch the backward recurrence on `stream` over rows [b0, b0 + B) of a
// batch of BS rows. layout: kFlat (f32 only: K4) or kStacked (K6c);
// xw_dtype (xw, out, d_out) / w_dtype: kF32 or kBF16. accumulate != 0 adds
// this launch's d_w_hh to d_w_hh's contents. barrier is one 32-bit word of
// scratch from the caller. Returns the CUDA error code (0 on success).
int svtsg_lstm_bwd(const void* xw, const void* w_hh, const void* out,
                   const float* c_seq, const void* d_out, const float* d_hT,
                   const float* d_cT, float* d_xw, float* d_w_hh,
                   unsigned int* barrier, int T, int B, int H, int b0, int BS,
                   int accumulate, int layout, int xw_dtype, int w_dtype,
                   int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return err;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const BwdArgs a{xw, w_hh, out, c_seq, d_out, d_hT, d_cT, d_xw, d_w_hh,
                    barrier, T, B, H, b0, BS, accumulate};
    if (layout == kFlat && xw_dtype == kF32 && w_dtype == kF32)
        return launch<kFlat, float, float>(a, st);
    if (layout != kStacked) return cudaErrorInvalidValue;
    if (xw_dtype == kF32 && w_dtype == kF32)
        return launch<kStacked, float, float>(a, st);
    if (xw_dtype == kF32 && w_dtype == kBF16)
        return launch<kStacked, float, bf16>(a, st);
    if (xw_dtype == kBF16 && w_dtype == kF32)
        return launch<kStacked, bf16, float>(a, st);
    if (xw_dtype == kBF16 && w_dtype == kBF16)
        return launch<kStacked, bf16, bf16>(a, st);
    return cudaErrorInvalidValue;
}

}  // extern "C"
