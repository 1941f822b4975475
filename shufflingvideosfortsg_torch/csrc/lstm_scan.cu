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
//
// What bounds it on an H100. Per layer the recurrence does 2*T*2*B*H*4H
// multiply-adds (4.3 GFLOP at T=128, B=32, H=256: 64 us at the 67 TFLOP/s
// f32 peak) against ~44 MB of traffic (13 us at 3.35 TB/s), so it is bound
// by operations; and the T steps are serially dependent, which adds a
// latency floor of one exchange of h per step that no roofline counts
// (svtsg_lstm_recurrence_floor measures it). W_hh is 2 MiB in f32, far
// beyond one block's 227 KB of shared memory, and h_t needs all of h_{t-1}.
//
// Design. The recurrence is independent across batch rows, so the batch is
// cut into near-equal row slices and each (direction, slice) is run by one
// thread-block cluster of 8 blocks; clusters never talk to each other, so
// there is no grid-wide barrier, no cooperative launch, no condition that
// all blocks be resident (clusters that do not fit queue) and no cap on
// the batch: any B is one launch. Block j of a cluster owns H/8 hidden
// units and keeps W_hh[d][:, the 4 gate columns of its units] on the SM as
// f32 for the whole run, so W_hh is read from device memory once a cluster:
// at H=256, the width of every cfg, in REGISTERS (a thread always multiplies
// by the same 32 rows x 4 gates of one unit: 128 registers, loaded once;
// one block an SM may use all 255 a thread), at any other width in shared
// memory (H * H/8 float4). A unit's cell state depends only on that
// unit's four gates, so c never leaves the block. Only h is exchanged, and
// through distributed shared memory: after a step every block writes its
// units of h_t, already rounded to WT, into the h buffer of all 8 blocks of
// its cluster (double-buffered by step parity), and one cluster barrier
// (arrive.release / wait.acquire) ends the step. The product is
// register-tiled (common.cuh, gate_product_reg, gate_product): a thread
// holds 5 or 10 rows x 4 gates of one unit for an eighth of k, so a float4
// of W feeds every row of the tile and a broadcast float4 of h every gate; the
// eight partial sums a (row, unit) are added in a fixed order. The step's
// gate inputs xw are fetched one step ahead with cp.async into shared
// memory, so no load from device memory lies on the serial chain, and out,
// c_seq, h_T and c_T are stored without anything waiting for them. bf16
// storage changes only the loads, the stores and the rounding points; the
// arithmetic stays f32. The rows one cluster can hold are bounded by shared
// memory (svtsg_lstm_max_rows: 59 at H=256 in f32, 70 with bf16 xw); the
// caller picks the number of slices, at least enough that every slice fits.

#include <cuda_runtime.h>
#include <math.h>

#include "common.cuh"

namespace {

using namespace svtsg;

__device__ __forceinline__ float sigmoid_bf16(float v) {
    // jax: one / (one + jnp.exp(-v)) on bf16 values, rounded after each op
    const float e = round_to<bf16>(expf(-v));
    return round_to<bf16>(1.0f / round_to<bf16>(1.0f + e));
}

// Byte offsets of a block's shared-memory regions for R rows at width H
// with xw in elements of x_bytes bytes. At H = kRegH the W slice is in
// registers and takes no shared memory.
struct FwdLayout {
    int w, h, part, xs, c, total;
    __host__ __device__ FwdLayout(int R, int H, int x_bytes) {
        const int UB = H / kClusterBlocks;
        w = 0;                                              // float4 [H][WS]
        h = w + (H == kRegH ? 0 : H * w_stride(UB) * 16);   // f32 [2][R][H+4]
        part = h + 2 * R * (H + 4) * 4;         // float4 [kSplits][kTile][UB]
        xs = part + kSplits * kTile * UB * 16;              // XT [2][R][4][UB]
        c = align16(xs + 2 * R * 4 * UB * x_bytes);         // f32 [R][UB]
        total = align16(c + R * UB * 4);
    }
};

// FLOOR leaves the product out (the recurrent term is taken as zero): what
// remains is the prefetch, the gate math, the stores, the exchange of h and
// the barrier, whose time is the latency floor of T dependent steps.
// KW > 0 is the kernel for H = kSplits * KW with the W slice in registers,
// KW = 0 the kernel for any H with the W slice in shared memory.
template <int L, typename XT, typename WT, bool GATES_BF16, bool FLOOR, int KW>
__global__ void __launch_bounds__(kThreads, 1)
lstm_fwd_kernel(const XT* __restrict__ xw, const WT* __restrict__ w_hh,
                XT* __restrict__ out, float* __restrict__ h_T,
                float* __restrict__ c_T, float* __restrict__ c_seq, int T,
                int B, int H, int n_slices) {
    extern __shared__ float4 smem4[];
    char* smem = reinterpret_cast<char*>(smem4);
    const int rank = cluster_rank();
    const int cid = blockIdx.x / kClusterBlocks;
    const int d = cid % 2;                       // direction
    int b0, R;                                   // this cluster's rows
    slice_rows(B, n_slices, cid / 2, b0, R);
    const int UB = H / kClusterBlocks, u0 = rank * UB;  // this block's units
    const int HP = H + 4;  // padded h row: 16-byte aligned
    const int tid = threadIdx.x;

    const FwdLayout lay(R, H, sizeof(XT));
    float4* w_s = reinterpret_cast<float4*>(smem + lay.w);
    float* h_s = reinterpret_cast<float*>(smem + lay.h);
    float4* part = reinterpret_cast<float4*>(smem + lay.part);
    XT* xs = reinterpret_cast<XT*>(smem + lay.xs);
    float* c_s = reinterpret_cast<float*>(smem + lay.c);
    const bool vec = (UB * sizeof(XT)) % 16 == 0;

    // the gate inputs of step s for this block: R rows x 4 gates x UB units
    auto prefetch_xw = [&](int s) {
        stage_segments(xs + (s & 1) * R * 4 * UB, R * 4, UB, vec, [&](int i) {
            return xw + xw_row<L>(s, d, b0 + i / 4, T, B, H) + (i % 4) * H + u0;
        });
        cp_async_commit();
    };
    prefetch_xw(0);
    float4 w_r[KW > 0 ? KW : 1];  // row warp * KW + k, this lane's unit
    if constexpr (KW > 0) {
        const WT* col = w_hh + ((size_t)d * H + (tid >> 5) * KW) * 4 * H + u0
                        + (tid & 31) % KW;
#pragma unroll
        for (int k = 0; k < KW; ++k) {
            const WT* row = col + (size_t)k * 4 * H;
            w_r[k] = make_float4(to_f32(row[0]), to_f32(row[H]),
                                 to_f32(row[2 * H]), to_f32(row[3 * H]));
        }
    } else {
        load_w_slice(w_s, w_hh + (size_t)d * H * 4 * H, H, UB, u0);
    }
    for (int e = tid; e < R * HP; e += blockDim.x) h_s[e] = 0.0f;  // h_{-1}
    for (int e = tid; e < R * UB; e += blockDim.x) c_s[e] = 0.0f;
    float* h_remote[kClusterBlocks];
#pragma unroll
    for (int j = 0; j < kClusterBlocks; ++j) h_remote[j] = remote_shared(h_s, j);
    cluster_sync();  // every block runs before any writes into another

    for (int s = 0; s < T; ++s) {
        const float* h_cur = h_s + (s & 1) * R * HP;
        const int next = ((s + 1) & 1) * R * HP;
        const XT* x_cur = xs + (s & 1) * R * 4 * UB;
        if (s + 1 < T) prefetch_xw(s + 1); else cp_async_commit();
        for (int r0 = 0; r0 < R; r0 += kTile) {
            const int rows = min(kTile, R - r0), rt = tile_rows(rows);
            if constexpr (FLOOR) {
            } else if constexpr (KW == 0) {
                gate_product_rows(w_s, h_cur + r0 * HP, part, rows, UB, HP);
            } else if (rt == kTile) {
                gate_product_reg<kTile>(w_r, h_cur + r0 * HP, part, HP);
            } else {
                gate_product_reg<kTile / 2>(w_r, h_cur + r0 * HP, part, HP);
            }
            if (r0 == 0) cp_async_wait<1>();  // this step's xw has landed
            __syncthreads();
            for (int p = tid; p < rows * UB; p += blockDim.x) {
                const int tr = p / UB, u = p % UB, r = r0 + tr;
                float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
                if constexpr (!FLOOR) a = gate_sum(part, rt, tr, u, UB);
                const XT* x = x_cur + r * 4 * UB + u;
                const float pi = to_f32(x[0]) + a.x;
                const float pf = to_f32(x[UB]) + a.y;
                const float pg = to_f32(x[2 * UB]) + a.z;
                const float po = to_f32(x[3 * UB]) + a.w;
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
                const float c = gf * c_s[r * UB + u] + gi * gg;
                const float h = go * tanhf(c);
                c_s[r * UB + u] = c;
                if (s + 1 < T) {
                    // rounded to WT as the next step's product takes it
                    const float hr = round_to<WT>(h);
                    const int at = next + r * HP + u0 + u;
#pragma unroll
                    for (int j = 0; j < kClusterBlocks; ++j)
                        h_remote[j][at] = hr;
                }
                const int row = b0 + r, unit = u0 + u;
                if (c_seq != nullptr)
                    c_seq[(((size_t)s * 2 + d) * B + row) * H + unit] = c;
                out[out_row<L>(s, d, row, T, B, H) + unit] = from_f32<XT>(h);
                if (s == T - 1) {
                    h_T[((size_t)d * B + row) * H + unit] = h;
                    c_T[((size_t)d * B + row) * H + unit] = c;
                }
            }
            if (r0 + kTile < R) __syncthreads();  // part is used again
        }
        if (s + 1 < T) cluster_sync();  // h_{s} has reached every block
    }
    cluster_sync();  // no block leaves while another may still write into it
}

struct FwdArgs {
    const void* xw;
    const void* w_hh;
    void* out;
    float* h_T;
    float* c_T;
    float* c_seq;
    int T, B, H, n_slices;
};

int max_rows(int H, int smem_limit, int x_bytes) {
    int R = 0;
    while (FwdLayout(R + 1, H, x_bytes).total <= smem_limit) ++R;
    return R;
}

template <int L, typename XT, typename WT, bool GATES_BF16, bool FLOOR = false>
cudaError_t launch(FwdArgs a, cudaStream_t st) {
    auto kernel = a.H == kRegH
                      ? lstm_fwd_kernel<L, XT, WT, GATES_BF16, FLOOR, kRegK>
                      : lstm_fwd_kernel<L, XT, WT, GATES_BF16, FLOOR, 0>;
    if (a.n_slices < 1 || a.n_slices > a.B || a.H % kClusterBlocks)
        return cudaErrorInvalidValue;
    const int rows = (a.B + a.n_slices - 1) / a.n_slices;
    const int smem = FwdLayout(rows, a.H, sizeof(XT)).total;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    ClusterLaunch cl(a.n_slices, smem, st);
    err = cudaLaunchKernelEx(&cl.cfg, kernel, static_cast<const XT*>(a.xw),
                             static_cast<const WT*>(a.w_hh),
                             static_cast<XT*>(a.out), a.h_T, a.c_T, a.c_seq,
                             a.T, a.B, a.H, a.n_slices);
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

// The most rows one cluster of the recurrence holds at width H, with xw in
// elements of x_bytes bytes, within smem_limit bytes of dynamic shared
// memory a block (0 when not even one row fits).
int svtsg_lstm_max_rows(int H, int smem_limit, int x_bytes) {
    return max_rows(H, smem_limit, x_bytes);
}

// The clusters of the recurrence that the card can hold at once with `rows`
// rows a cluster at width H and xw in elements of x_bytes bytes, or minus
// the CUDA error code. The wrapper plans the row slices of a launch from
// it. Asked of the f32 (x_bytes 4) or the bf16-xw, f32-W_hh instantiation,
// which stands for the others of its storage type: they share its shared
// memory, and at H = kRegH every one needs the registers of a whole SM.
int svtsg_lstm_active_clusters(int H, int rows, int x_bytes, int device) {
    const int smem = FwdLayout(rows, H, x_bytes).total;
    if (x_bytes == sizeof(float))
        return active_clusters(
            H == kRegH
                ? lstm_fwd_kernel<kFlat, float, float, false, false, kRegK>
                : lstm_fwd_kernel<kFlat, float, float, false, false, 0>,
            smem, device);
    return active_clusters(
        H == kRegH ? lstm_fwd_kernel<kStacked, bf16, float, false, false, kRegK>
                   : lstm_fwd_kernel<kStacked, bf16, float, false, false, 0>,
        smem, device);
}

// Launch the recurrence on `stream` over a batch of B rows cut into
// n_slices near-equal row slices, one cluster a (direction, slice). layout:
// kFlat (f32 only, no gates_bf16: K1, K3) or kStacked (K6a, K6b); xw_dtype /
// w_dtype: kF32 or kBF16. c_seq is the [T, 2, B, H] residual (K3, K6b) or
// null (K1, K6a). Returns the CUDA error code (0 on success).
int svtsg_lstm_recurrence(const void* xw, const void* w_hh, void* out,
                          float* h_T, float* c_T, float* c_seq, int T, int B,
                          int H, int n_slices, int layout, int xw_dtype,
                          int w_dtype, int gates_bf16, int device,
                          void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return err;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const FwdArgs a{xw, w_hh, out, h_T, c_T, c_seq, T, B, H, n_slices};
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

// The flat f32 recurrence with the product left out: the time of T
// dependent steps of prefetch, gate math, stores, exchange and barrier.
// Same arguments as svtsg_lstm_recurrence's flat f32 case; its outputs are
// those of a layer whose W_hh is zero.
int svtsg_lstm_recurrence_floor(const void* xw, const void* w_hh, void* out,
                                float* h_T, float* c_T, int T, int B, int H,
                                int n_slices, int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return err;
    const FwdArgs a{xw, w_hh, out, h_T, c_T, nullptr, T, B, H, n_slices};
    return launch<kFlat, float, float, false, true>(
        a, static_cast<cudaStream_t>(stream));
}

const char* svtsg_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
