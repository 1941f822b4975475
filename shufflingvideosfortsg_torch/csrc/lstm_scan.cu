// K1, K3, K6a and K6b: the BiLSTM recurrence, both directions in one launch.
//
// One kernel template serves four Pallas TPU kernels of
// shufflingvideosfortsg_tpu/ops/pallas/lstm_scan.py:
//   K1  `lstm_scan_pallas_flat` (:303, body `_lstm_kernel_flat` :159):
//       flat layout, f32, or xw/out and w_hh both bf16 (the model at
//       `precision: bf16`, whose BiLSTM casts w_hh to bf16: ops/rnn.py:213);
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
// arithmetic stays f32, except that with bf16 W_hh at H=256 the product
// runs on the bf16 tensor cores and h is exchanged in bf16
// (lstm_fwd_mma_kernel below). The rows one cluster can hold are bounded by
// shared memory (svtsg_lstm_max_rows: 59 at H=256 in f32, 70 with bf16 xw
// and f32 W_hh, 127 on the tensor cores with bf16 xw); the caller picks the
// number of slices, at least enough that every slice fits.
// From H = 304 in f32 the shared slice (H * H/8 float4: 532 KB at H=512)
// leaves no row, and the caller passes w_glob: a layout kernel writes the
// slices once a launch to device memory (common.cuh, w_layout_kernel), where
// they stay in L2, and the same product code reads them from there, so the
// block's shared memory holds only rows (23 a cluster at H=512 in f32).

#include <cuda_runtime.h>
#include <math.h>

#include <type_traits>

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
// registers, and with w_global in device memory; neither takes shared
// memory.
struct FwdLayout {
    int w, h, part, xs, c, total;
    __host__ __device__ FwdLayout(int R, int H, int x_bytes, bool w_global) {
        const int UB = H / kClusterBlocks;
        const bool w_here = H != kRegH && !w_global;
        w = 0;                                              // float4 [H][WS]
        h = w + (w_here ? H * w_stride(UB) * 16 : 0);       // f32 [2][R][H+4]
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
// KW = 0 the kernel for any H with the W slice in shared memory, or, where
// w_glob is given, read from it in device memory (w_layout_kernel).
template <int L, typename XT, typename WT, bool GATES_BF16, bool FLOOR, int KW>
__global__ void __launch_bounds__(kThreads, 1)
lstm_fwd_kernel(const XT* __restrict__ xw, const WT* __restrict__ w_hh,
                XT* __restrict__ out, float* __restrict__ h_T,
                float* __restrict__ c_T, float* __restrict__ c_seq,
                const float4* __restrict__ w_glob, int T, int B, int H,
                int n_slices) {
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

    const FwdLayout lay(R, H, sizeof(XT), w_glob != nullptr);
    float4* w_s = reinterpret_cast<float4*>(smem + lay.w);
    // the product's W slice: in shared memory, or in device memory
    const float4* w_src = w_glob ? w_global_slice(w_glob, d, rank, H) : w_s;
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
    } else if (w_glob == nullptr) {
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
                gate_product_rows(w_src, h_cur + r0 * HP, part, rows, UB, HP);
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

// --- bf16 W_hh at H = kRegH: the product on the tensor cores -----------------
//
// With W_hh in bf16 (K1 and K3 at `precision: bf16`, K6a/K6b with bf16
// w_hh) h is rounded to bf16 before the product, so every product of the
// step's h_{s-1}[R, 256] @ W_hh[d][:, the block's 128 gate columns] is of
// two bf16 values and exact in f32: the kernel below multiplies on the
// tensor cores (mma.sync m16n8k16, bf16 in, f32 accumulators) and only the
// order of the f32 sums differs from lstm_fwd_kernel's. The partition, the
// xw prefetch, the gate arithmetic and the cluster barrier are
// lstm_fwd_kernel's; what changes:
//  - The product is W^T h^T: the block's gate columns are the mma's rows m
//    and the batch rows its columns n, so a ragged R pads to 8 (an n8
//    tile), in the fragments only: lanes past the slice read row R - 1 and
//    their sums are never used.
//  - W lives in registers as bf16 A fragments (64 a thread; the f32 slice
//    of lstm_fwd_kernel takes 128). Warp w takes the k half kh = w / 4 and the unit group grp = w
//    % 4 (8 of the block's 32 units); its two m16 tiles are the (i, f) and
//    the (g, o) gate columns of those units, so a thread's accumulators
//    hold all four gates of one unit for two rows.
//  - h is exchanged in bf16 (half the bytes), into a bf16 buffer whose
//    528-byte rows put the 8 rows an ldmatrix reads in distinct banks. Each
//    warp reads h's k half only: every element 4 times a step, not 8.
//  - Rows go 16 at a time (two n8 tiles): the warps of the two k halves of
//    a unit group add their partial sums through 512 bytes of shared memory
//    and a barrier of the two warps; the first takes the gate epilogue of
//    the first 8 rows, the second of the next 8 (where those lie past R,
//    both multiply the first 8 alone and each takes every other row of
//    them). The next 16 rows' products are issued before this epilogue,
//    which hides their latency.
//  - Step 0's product (h = 0) is not taken.
// The rows one cluster holds: FwdMmaLayout (127 at bf16 xw, 97 at f32 xw).

constexpr int kMmaHLd = kRegH + 8;  // bf16 row stride of the h buffer
constexpr int kMmaUnits = 8;        // units of a warp's unit group
static_assert(kRegH / kClusterBlocks == 4 * kMmaUnits
                  && kThreads == 8 * 32 && kRegH % 32 == 0,
              "4 unit groups x 2 k halves of 8 k16 steps");

// Byte offsets of a block's shared-memory regions for R rows with xw in
// elements of x_bytes bytes.
struct FwdMmaLayout {
    int h, part, xs, c, total;
    __host__ __device__ FwdMmaLayout(int R, int x_bytes) {
        constexpr int UB = kRegH / kClusterBlocks;
        h = 0;                                 // bf16 [2][R][kMmaHLd]
        part = h + 2 * R * kMmaHLd * 2;        // float4 [4][2][2][2][32]
        xs = part + 4 * 2 * 2 * 2 * 32 * 16;   // XT [2][R][4][UB]
        c = align16(xs + 2 * R * 4 * UB * x_bytes);  // f32 [R][UB]
        total = align16(c + R * UB * 4);
    }
};

// c and h of one (row, unit) from its four gate pre-activations and c_prev,
// with lstm_fwd_kernel's arithmetic.
template <bool GATES_BF16>
__device__ __forceinline__ void lstm_cell(float pi, float pf, float pg,
                                          float po, float c_prev, float& c,
                                          float& h) {
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
    c = gf * c_prev + gi * gg;
    h = go * tanhf(c);
}

// acc[mt][n] += W^T's A fragments wa[mt][kt] times the h rows of
// ldmatrix's matrices 2n and 2n + 1 (at hp, k16 step kt at hp + 16 kt), for
// the n that FIRST (n = 0) and SECOND (n = 1) select.
template <bool FIRST, bool SECOND>
__device__ __forceinline__ void mma_rows(float (&acc)[2][2][4],
                                         const unsigned (&wa)[2][8][4],
                                         const bf16* hp) {
#pragma unroll
    for (int kt = 0; kt < 8; ++kt) {
        unsigned b[4];
        ldmatrix_x4(b, hp + 16 * kt);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
            if constexpr (FIRST) mma_bf16(acc[mt][0], wa[mt][kt], b[0], b[1]);
            if constexpr (SECOND) mma_bf16(acc[mt][1], wa[mt][kt], b[2], b[3]);
        }
    }
}

// lstm_fwd_kernel's arguments (w_glob and H unused: H = kRegH).
template <int L, typename XT, bool GATES_BF16, bool FLOOR>
__global__ void __launch_bounds__(kThreads, 1)
lstm_fwd_mma_kernel(const XT* __restrict__ xw, const bf16* __restrict__ w_hh,
                    XT* __restrict__ out, float* __restrict__ h_T,
                    float* __restrict__ c_T, float* __restrict__ c_seq,
                    const float4* __restrict__, int T, int B, int,
                    int n_slices) {
    constexpr int H = kRegH, H4 = 4 * H, UB = H / kClusterBlocks;
    extern __shared__ float4 smem4[];
    char* smem = reinterpret_cast<char*>(smem4);
    const int rank = cluster_rank();
    const int cid = blockIdx.x / kClusterBlocks;
    const int d = cid % 2;                       // direction
    int b0, R;                                   // this cluster's rows
    slice_rows(B, n_slices, cid / 2, b0, R);
    const int u0 = rank * UB;                    // this block's units
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const int kh = warp >> 2, grp = warp & 3;
    const int u = grp * kMmaUnits + g;           // this thread's unit

    const FwdMmaLayout lay(R, sizeof(XT));
    bf16* h_s = reinterpret_cast<bf16*>(smem + lay.h);
    float4* part = reinterpret_cast<float4*>(smem + lay.part);
    XT* xs = reinterpret_cast<XT*>(smem + lay.xs);
    float* c_s = reinterpret_cast<float*>(smem + lay.c);

    auto prefetch_xw = [&](int s) {
        stage_segments(xs + (s & 1) * R * 4 * UB, R * 4, UB, true, [&](int i) {
            return xw + xw_row<L>(s, d, b0 + i / 4, T, B, H) + (i % 4) * H + u0;
        });
        cp_async_commit();
    };
    prefetch_xw(0);
    // W^T's A fragments: m16 tile mt holds the columns of gates 2 mt (rows
    // m < 8) and 2 mt + 1 (m >= 8) of the group's units, k16 step kt the
    // rows k = 16 (8 kh + kt) ..
    unsigned wa[2][8][4];
    if constexpr (!FLOOR) {
        const bf16* wd = w_hh + (size_t)d * H * H4;
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int kt = 0; kt < 8; ++kt) {
                const bf16* p = wd + (size_t)((8 * kh + kt) * 16 + 2 * t) * H4
                                + 2 * mt * H + u0 + u;
                wa[mt][kt][0] = pack_bf16(p[0], p[H4]);
                wa[mt][kt][1] = pack_bf16(p[H], p[H4 + H]);
                wa[mt][kt][2] = pack_bf16(p[8 * H4], p[9 * H4]);
                wa[mt][kt][3] = pack_bf16(p[8 * H4 + H], p[9 * H4 + H]);
            }
    }
    for (int e = tid; e < R * UB; e += blockDim.x) c_s[e] = 0.0f;
    bf16* h_remote[kClusterBlocks];
#pragma unroll
    for (int j = 0; j < kClusterBlocks; ++j) h_remote[j] = remote_shared(h_s, j);
    // lane l gives row l % 8 of matrix l / 8 of an ldmatrix.x4: matrices 0
    // and 1 are k 0-7 and 8-15 of the 8 rows this warp finalizes, 2 and 3
    // those of the partner's 8
    const int l_row = (((lane >> 4) ^ kh) << 3) + (lane & 7);
    const int l_col = kh * (H / 2) + ((lane >> 3) & 1) * 8;
    float4* give = part + (grp * 2 + kh) * 2 * 2 * 32;      // [parity][2][32]
    const float4* take = part + (grp * 2 + (kh ^ 1)) * 2 * 2 * 32;
    // The products of the 16 rows from r0 over this warp's k half: acc[mt][0]
    // for the 8 rows of ldmatrix's matrices 0 and 1, acc[mt][1] for the
    // other 8 (lanes past R read row R - 1). Where the second 8 rows lie
    // past R, only the first 8 are multiplied (for kh = 1 they are its
    // acc[mt][1]): the pair's two warps share one tensor core.
    float acc[2][2][4];
    auto product = [&](const bf16* h_cur, int r0) {
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int n = 0; n < 2; ++n)
#pragma unroll
                for (int q = 0; q < 4; ++q) acc[mt][n][q] = 0.f;
        const bf16* hp = h_cur + min(r0 + l_row, R - 1) * kMmaHLd + l_col;
        if (r0 + 8 < R)
            mma_rows<true, true>(acc, wa, hp);
        else if (kh == 0)
            mma_rows<true, false>(acc, wa, hp);
        else
            mma_rows<false, true>(acc, wa, hp);
    };
    cluster_sync();  // every block runs before any writes into another

    for (int s = 0; s < T; ++s) {
        const bf16* h_cur = h_s + (s & 1) * R * kMmaHLd;
        const int next = ((s + 1) & 1) * R * kMmaHLd;
        const XT* x_cur = xs + (s & 1) * R * 4 * UB;
        const bool mult = !FLOOR && s > 0;  // step 0's h is zero
        if (s + 1 < T) prefetch_xw(s + 1); else cp_async_commit();
        if (mult) product(h_cur, 0);
        cp_async_wait<1>();  // this step's xw has landed ...
        __syncthreads();     // ... for every thread
        for (int r0 = 0, parity = 0; r0 < R; r0 += 16, parity ^= 1) {
            // A chunk whose second 8 rows lie past R splits its first 8
            // between the pair: each warp takes rows 2t + kh of them.
            const bool split = r0 + 8 >= R;
            // sum[mt][i]: the full sums of accumulator column i (gate 2 mt
            // of the rows' column i < 2, gate 2 mt + 1 of column i - 2)
            float sum[2][4] = {};
            if (mult) {
                // the partner adds what this warp gives, in kh order
                const bool give_first = split && kh == 0;
                const bool own_second = split && kh == 1;
                float4* mine = give + parity * 2 * 32;
                const float4* theirs = take + parity * 2 * 32;
                // (selects of values: acc stays in registers)
#pragma unroll
                for (int mt = 0; mt < 2; ++mt) {
                    float a[4];
#pragma unroll
                    for (int q = 0; q < 4; ++q)
                        a[q] = give_first ? acc[mt][0][q] : acc[mt][1][q];
                    mine[mt * 32 + lane] = make_float4(a[0], a[1], a[2], a[3]);
                }
                pair_barrier(1 + grp);
#pragma unroll
                for (int mt = 0; mt < 2; ++mt) {
                    const float4 o = theirs[mt * 32 + lane];
                    const float other[4] = {o.x, o.y, o.z, o.w};
#pragma unroll
                    for (int q = 0; q < 4; ++q)
                        sum[mt][q] = (own_second ? acc[mt][1][q]
                                                 : acc[mt][0][q]) + other[q];
                }
                // the next chunk's products overlap this chunk's epilogue
                if (r0 + 16 < R) product(h_cur, r0 + 16);
            }
            // the gate epilogue of unit u and rows r0 + 8 kh + 2t + j (split:
            // row r0 + 2t + kh alone), loads first, then the cells
            int rr[2];
            bool ok[2];
            float xin[2][4], c_prev[2], cn[2], hn[2], hr[2] = {};
#pragma unroll
            for (int j = 0; j < 2; ++j) {
                rr[j] = split ? r0 + 2 * t + kh : r0 + 8 * kh + 2 * t + j;
                ok[j] = rr[j] < R && (j == 0 || !split);
                const int rc = ok[j] ? rr[j] : 0;
                const XT* x = x_cur + rc * 4 * UB + u;
#pragma unroll
                for (int q = 0; q < 4; ++q) xin[j][q] = to_f32(x[q * UB]);
                c_prev[j] = c_s[rc * UB + u];
            }
            auto cell = [&](int j) {
                const bool i = split ? kh : j;  // the row's accumulator column
                lstm_cell<GATES_BF16>(xin[j][0] + (i ? sum[0][1] : sum[0][0]),
                                      xin[j][1] + (i ? sum[0][3] : sum[0][2]),
                                      xin[j][2] + (i ? sum[1][1] : sum[1][0]),
                                      xin[j][3] + (i ? sum[1][3] : sum[1][2]),
                                      c_prev[j], cn[j], hn[j]);
                hr[j] = round_to<bf16>(hn[j]);  // as the next product takes it
            };
            // both cells side by side; a split chunk's warps have one row
            if (split) {
                cell(0);
            } else {
                cell(0);
                cell(1);
            }
            if (s + 1 < T) {
                // units u and u ^ 1 (lanes 4 apart) meet: the even one sends
                // its second row, the odd one its first, and each writes the
                // pair of one row; split: the even one writes the row's pair
                const int odd = g & 1;
                const float other = __shfl_xor_sync(
                    0xffffffffu, odd || split ? hr[0] : hr[1], 4);
                const unsigned v =
                    odd ? pack_bf16(__float2bfloat16_rn(other),
                                    __float2bfloat16_rn(hr[1]))
                        : pack_bf16(__float2bfloat16_rn(hr[0]),
                                    __float2bfloat16_rn(other));
                const bool second = odd && !split;
                if (!(odd && split) && (second ? ok[1] : ok[0])) {
                    const int at = next + (second ? rr[1] : rr[0]) * kMmaHLd
                                   + u0 + (u & ~1);
#pragma unroll
                    for (int j = 0; j < kClusterBlocks; ++j)
                        *reinterpret_cast<unsigned*>(h_remote[j] + at) = v;
                }
            }
#pragma unroll
            for (int j = 0; j < 2; ++j) {
                if (!ok[j]) continue;
                const int r = rr[j], row = b0 + r, unit = u0 + u;
                c_s[r * UB + u] = cn[j];
                if (c_seq != nullptr)
                    c_seq[(((size_t)s * 2 + d) * B + row) * H + unit] = cn[j];
                out[out_row<L>(s, d, row, T, B, H) + unit] = from_f32<XT>(hn[j]);
                if (s == T - 1) {
                    h_T[((size_t)d * B + row) * H + unit] = hn[j];
                    c_T[((size_t)d * B + row) * H + unit] = cn[j];
                }
            }
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
    float4* w_glob;  // null, or the device-memory slices (w_layout_kernel)
    int T, B, H, n_slices;
};

// A block's dynamic shared memory for R rows.
int fwd_smem(int R, int H, int x_bytes, int w_bytes, bool w_global) {
    return on_tensor_cores(H, w_bytes)
               ? FwdMmaLayout(R, x_bytes).total
               : FwdLayout(R, H, x_bytes, w_global).total;
}

int max_rows(int H, int smem_limit, int x_bytes, int w_bytes, bool w_global) {
    int R = 0;
    while (fwd_smem(R + 1, H, x_bytes, w_bytes, w_global) <= smem_limit) ++R;
    return R;
}

// The kernel of an instantiation at width H.
template <int L, typename XT, typename WT, bool GATES_BF16, bool FLOOR>
auto fwd_kernel(int H) {
    if constexpr (std::is_same<WT, bf16>::value)
        return H == kRegH ? lstm_fwd_mma_kernel<L, XT, GATES_BF16, FLOOR>
                          : lstm_fwd_kernel<L, XT, WT, GATES_BF16, FLOOR, 0>;
    else
        return H == kRegH
                   ? lstm_fwd_kernel<L, XT, WT, GATES_BF16, FLOOR, kRegK>
                   : lstm_fwd_kernel<L, XT, WT, GATES_BF16, FLOOR, 0>;
}

template <int L, typename XT, typename WT, bool GATES_BF16, bool FLOOR = false>
cudaError_t launch(FwdArgs a, cudaStream_t st) {
    auto kernel = fwd_kernel<L, XT, WT, GATES_BF16, FLOOR>(a.H);
    if (a.n_slices < 1 || a.n_slices > a.B || a.H % kClusterBlocks
        || (a.w_glob && (a.H == kRegH || FLOOR)))
        return cudaErrorInvalidValue;
    const int rows = (a.B + a.n_slices - 1) / a.n_slices;
    const int smem = fwd_smem(rows, a.H, sizeof(XT), sizeof(WT),
                              a.w_glob != nullptr);
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    if (a.w_glob) {
        err = launch_w_layout(static_cast<const WT*>(a.w_hh), a.w_glob, a.H,
                              st);
        if (err != cudaSuccess) return err;
    }
    ClusterLaunch cl(2 * a.n_slices, kClusterBlocks, smem, st);
    err = cudaLaunchKernelEx(&cl.cfg, kernel, static_cast<const XT*>(a.xw),
                             static_cast<const WT*>(a.w_hh),
                             static_cast<XT*>(a.out), a.h_T, a.c_T, a.c_seq,
                             static_cast<const float4*>(a.w_glob), a.T, a.B,
                             a.H, a.n_slices);
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
// elements of x_bytes bytes and W_hh in elements of w_bytes bytes, within
// smem_limit bytes of dynamic shared memory a block (0 when not even one
// row fits), with the W slice in shared memory or (w_global) in device
// memory.
int svtsg_lstm_max_rows(int H, int smem_limit, int x_bytes, int w_bytes,
                        int w_global) {
    return max_rows(H, smem_limit, x_bytes, w_bytes, w_global);
}

// The clusters of the recurrence that the card can hold at once with `rows`
// rows a cluster at width H, xw and W_hh in elements of x_bytes and w_bytes
// bytes and the W slice where w_global says, or minus the CUDA error code.
// The wrapper plans the row slices of a launch from it. Asked of the f32
// (x_bytes 4) or the bf16-xw, f32-W_hh instantiation, which stands for the
// others of its storage type: they share its shared memory, and at H =
// kRegH every one needs the registers of a whole SM; and at H = kRegH with
// bf16 W_hh of the tensor-core kernel of the flat bf16 (x_bytes 2) or the
// stacked f32-xw layout.
int svtsg_lstm_active_clusters(int H, int rows, int x_bytes, int w_bytes,
                               int w_global, int device) {
    const int smem = fwd_smem(rows, H, x_bytes, w_bytes, w_global);
    if (on_tensor_cores(H, w_bytes))
        return x_bytes == sizeof(float)
                   ? active_clusters(
                         lstm_fwd_mma_kernel<kStacked, float, false, false>,
                         smem, device)
                   : active_clusters(
                         lstm_fwd_mma_kernel<kFlat, bf16, false, false>, smem,
                         device);
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
// kFlat (xw and w_hh both f32 or both bf16, no gates_bf16: K1, K3) or
// kStacked (K6a, K6b); xw_dtype / w_dtype: kF32 or kBF16. c_seq is the [T, 2, B, H] residual (K3, K6b) or
// null (K1, K6a). w_glob is null (the W slices in shared memory, or in
// registers at H = 256) or 2 * 8 * H * (H/8 | 1) float4 of device memory,
// where a layout kernel first writes the slices for the recurrence to read
// (not at H = 256). Returns the CUDA error code (0 on success).
int svtsg_lstm_recurrence(const void* xw, const void* w_hh, void* out,
                          float* h_T, float* c_T, float* c_seq, void* w_glob,
                          int T, int B, int H, int n_slices, int layout,
                          int xw_dtype, int w_dtype, int gates_bf16,
                          int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return err;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const FwdArgs a{xw, w_hh, out, h_T, c_T, c_seq,
                    static_cast<float4*>(w_glob), T, B, H, n_slices};
    if (layout == kFlat && !gates_bf16 && xw_dtype == w_dtype
        && (xw_dtype == kF32 || xw_dtype == kBF16))
        return xw_dtype == kF32 ? launch<kFlat, float, float, false>(a, st)
                                : launch<kFlat, bf16, bf16, false>(a, st);
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

// The flat recurrence (xw and w_hh both f32 or, dtype kBF16, both bf16)
// with the product left out: the time of T dependent steps of prefetch,
// gate math, stores, exchange and barrier of that instantiation's kernel.
// Same arguments as svtsg_lstm_recurrence's flat case; its outputs are
// those of a layer whose W_hh is zero.
int svtsg_lstm_recurrence_floor(const void* xw, const void* w_hh, void* out,
                                float* h_T, float* c_T, int T, int B, int H,
                                int n_slices, int dtype, int device,
                                void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return err;
    const FwdArgs a{xw, w_hh, out, h_T, c_T, nullptr, nullptr, T, B, H,
                    n_slices};
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (dtype == kF32) return launch<kFlat, float, float, false, true>(a, st);
    if (dtype == kBF16) return launch<kFlat, bf16, bf16, false, true>(a, st);
    return cudaErrorInvalidValue;
}

const char* svtsg_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
