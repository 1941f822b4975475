// K4 and K6c: the BiLSTM backward recurrence, both directions in one launch.
//
// One kernel template serves two Pallas TPU kernels of
// shufflingvideosfortsg_tpu/ops/pallas/lstm_scan.py:
//   K4  `lstm_scan_pallas_bwd_flat` (:1024, body `_lstm_bwd_kernel_flat`
//       :766): flat layout, xw/out/d_out and w_hh both f32 or both bf16
//       (the model at `precision: bf16`: `lstm_flat_fused` takes bf16 xw
//       and w_hh, ops/rnn.py:201-225);
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
// in f32; d_xw holds the f32 dgates.
//
// What bounds it on an H100. Per layer it does three products of the
// forward's size: the gate recompute h_prev @ W_hh, dh_prev = dgates @
// W_hh^T and d_w_hh = sum_s h_prev^T @ dgates, 3 * 2*T*2*B*H*4H = 25.8 GFLOP
// at T=128, B=64, H=256 (0.385 ms at the 67 TFLOP/s f32 peak), against
// ~120 MB of traffic (36 us at 3.35 TB/s): bound by operations. The T steps
// are serially dependent, and dh_prev needs every gate column of the step:
// one exchange per step, which no roofline counts.
//
// Design. Two kernels, launched one after the other on the caller's stream
// by one C entry point.
//
// 1. The recurrence (lstm_bwd_kernel) has the forward's partition
//    (lstm_scan.cu): a cluster of 8 blocks a (direction, slice of batch
//    rows), block j owning H/8 units and the W_hh[d][:, 4 gate columns of its
//    units] slice in shared memory; no grid-wide barrier, no cooperative
//    launch, any B in one launch. Only two things lie on a step's serial
//    chain: the elementwise gate algebra (dh, dc -> the four dgates, written
//    straight into d_xw) and dh_prev. For dh_prev block j forms the partial
//    dgates[rows, own columns] @ W_hh[:, own columns]^T for ALL H units (at
//    H=256 from W values a thread keeps in registers for the whole run:
//    dh_product_reg; at other widths from the shared-memory slice, a
//    thread owning one k and 5 or 10 rows, the slice's row stride odd so
//    that a warp's 32 k spread over all banks: dh_product) and
//    writes each unit's partial into the owner block's shared memory
//    (distributed shared memory, double-buffered by step parity); after the
//    cluster barrier the owner adds the 8 partials in a fixed order. dc
//    never leaves the block. The gate recompute of the NEXT step (it needs
//    only xw and out, saved by the forward) runs between the barrier's
//    arrive and its wait, so the exchange's latency hides behind it; xw,
//    h_prev, d_out and c_seq are fetched a step ahead with cp.async while
//    the chain's part of the step runs, so no load from device memory lies
//    on the chain.
//    Where the shared slice leaves no row (H >= 304 in f32), the caller
//    passes w_glob and the slices are read from device memory, laid out
//    once a launch by a layout kernel (common.cuh), as in the forward: 15
//    rows a cluster at H=512 in f32.
// 2. The weight gradient (lstm_weight_grad_kernel) is out of the loop: once
//    d_xw is written, d_w_hh[d] = sum_s h_prev[s]^T @ dgates[s] depends on
//    nothing in the chain. It is an [H, P]^T x [P, 4H] product a direction
//    over the P = (T-1)*B pairs (s, b), split over the pairs (split-K)
//    inside a thread-block cluster: a cluster owns one 128 x 128 output
//    tile and each of its S <= 8 blocks a contiguous 1/S of the pairs
//    (ops/lstm_scan.py picks S from the clusters the card holds at once, so
//    that the grid fills whole waves); a thread keeps 8 x 8 outputs, the
//    operands stream through a 6-stage cp.async ring, where each thread
//    rounds the values it copied to WT once they land; then the S partial
//    tiles are added through
//    distributed shared memory in rank order, each block summing and
//    storing 1/S of the tile: a fixed order (no atomics), no workspace, one
//    launch.

#include <cuda_runtime.h>
#include <math.h>

#include <type_traits>

#include "common.cuh"

namespace {

using namespace svtsg;

// Byte offsets of a block's shared-memory regions for R rows at width H
// with xw, out and d_out in elements of x_bytes bytes. With w_global the W
// slice is read from device memory and takes no shared memory.
struct BwdLayout {
    int w, h, part, xs, dout, cb, dg, dc, recv, total;
    __host__ __device__ BwdLayout(int R, int H, int x_bytes, bool w_global) {
        const int UB = H / kClusterBlocks, RU = align16(R * UB * 4);
        w = 0;                                     // float4 [H][WS]
        // h_prev = out[s-1]: staged as XT (bf16 in the upper half), then
        // widened and rounded to WT in place as f32 [R][H]
        h = w + (w_global ? 0 : H * w_stride(UB) * 16);
        part = h + R * H * 4;                  // float4 [kSplits][kTile][UB]
        xs = part + kSplits * kTile * UB * 16;     // XT [R][4][UB]: xw[s]
        dout = align16(xs + R * 4 * UB * x_bytes); // XT [2][R][UB]: d_out[s]
        cb = dout + 2 * RU;                        // f32 [3][R][UB]: c_seq
        dg = cb + 3 * RU;          // float4 [R][UB]: gate inputs, then dgates
        dc = dg + R * UB * 16;                     // f32 [R][UB]
        recv = dc + RU;                            // f32 [2][8][R][UB]
        total = recv + 2 * kClusterBlocks * RU;
    }
};

// h_prev for the product, in place: n elements staged as XT at `src` become
// f32 rounded to WT at dst[0..n). Where XT is bf16, src is the upper half of
// dst, so a pass reads its elements into registers before any is written;
// what a pass overwrites lies below what later passes read.
template <typename XT, typename WT>
__device__ __forceinline__ void widen_in_place(float* dst, const XT* src,
                                               int n) {
    if constexpr (sizeof(XT) == 4) {
        if constexpr (sizeof(WT) != 4) {
            for (int e = threadIdx.x; e < n; e += blockDim.x)
                dst[e] = round_to<WT>(dst[e]);
            __syncthreads();
        }
    } else {
        constexpr int kPer = 16;  // elements a thread holds a pass
        for (int base = 0; base < n; base += kPer * blockDim.x) {
            float v[kPer];
#pragma unroll
            for (int i = 0; i < kPer; ++i) {
                const int e = base + i * blockDim.x + threadIdx.x;
                v[i] = e < n ? round_to<WT>(to_f32(src[e])) : 0.f;
            }
            __syncthreads();
#pragma unroll
            for (int i = 0; i < kPer; ++i) {
                const int e = base + i * blockDim.x + threadIdx.x;
                if (e < n) dst[e] = v[i];
            }
        }
        __syncthreads();
    }
}

// Partial dh_prev of RT rows: thread k forms sum over this block's 4*UB
// gate columns of dgates[row][col] * W_hh[k][col] and writes it to the
// block that owns unit k, into recv[this block's rank][row][k % UB].
template <int RT>
__device__ __forceinline__ void dh_product(const float4* __restrict__ w_s,
                                           const float4* __restrict__ dg,
                                           float* recv_next, int rank, int r0,
                                           int rows, int R, int H, int UB) {
    const int WS = w_stride(UB);
    for (int k = threadIdx.x; k < H; k += blockDim.x) {
        float acc[RT];
#pragma unroll
        for (int r = 0; r < RT; ++r) acc[r] = 0.f;
        const float4* wk = w_s + k * WS;
        const float4* dgr[RT];  // rows past the slice repeat the last one
#pragma unroll
        for (int r = 0; r < RT; ++r) dgr[r] = dg + min(r, rows - 1) * UB;
#pragma unroll 4
        for (int u = 0; u < UB; ++u) {
            const float4 wv = wk[u];
#pragma unroll
            for (int r = 0; r < RT; ++r) {
                const float4 g = dgr[r][u];
                acc[r] = fmaf(g.x, wv.x, acc[r]);
                acc[r] = fmaf(g.y, wv.y, acc[r]);
                acc[r] = fmaf(g.z, wv.z, acc[r]);
                acc[r] = fmaf(g.w, wv.w, acc[r]);
            }
        }
        float* dst = remote_shared(recv_next, k / UB)
                     + ((size_t)rank * R + r0) * UB + k % UB;
#pragma unroll
        for (int r = 0; r < RT; ++r)
            if (r < rows) dst[r * UB] = acc[r];
    }
}

// The same partial with the thread's W values in registers, for the width
// H = kSplits * KW = kThreads. Thread (kq, us) owns the four units
// k = 4 kq .. 4 kq + 3 and an us-th quarter of this block's units u (KW / 4
// of them): w[j * 4 + i] is the float4 (i, f, g, o) of W_hh[4 kq + i][unit
// us * KW / 4 + j], loaded once for the whole run, so one broadcast float4
// of dgates feeds 16 multiply-adds and the step loads nothing else from
// shared memory. The four quarters' sums meet in `part` ([4][RT][H]
// floats), and thread k adds them in a fixed order and writes the result to
// the block that owns unit k.
template <int RT, int KW>
__device__ __forceinline__ void dh_product_reg(const float4 (&w)[KW],
                                               const float4* __restrict__ dg,
                                               float* __restrict__ part,
                                               float* recv_next, int rank,
                                               int r0, int rows, int R) {
    constexpr int H = kSplits * KW, UB = KW, UJ = KW / 4, kQuads = H / 4;
    static_assert(H == kThreads && KW % 4 == 0, "one thread a unit k");
    const int kq = threadIdx.x % kQuads, us = threadIdx.x / kQuads;
    float acc[RT][4];
    const float4* dgr[RT];  // rows past the slice repeat the last one
#pragma unroll
    for (int r = 0; r < RT; ++r) {
        dgr[r] = dg + min(r, rows - 1) * UB + us * UJ;
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[r][i] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < UJ; ++j) {
#pragma unroll
        for (int r = 0; r < RT; ++r) {
            const float4 g = dgr[r][j];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                const float4 wv = w[j * 4 + i];
                acc[r][i] = fmaf(g.x, wv.x, acc[r][i]);
                acc[r][i] = fmaf(g.y, wv.y, acc[r][i]);
                acc[r][i] = fmaf(g.z, wv.z, acc[r][i]);
                acc[r][i] = fmaf(g.w, wv.w, acc[r][i]);
            }
        }
    }
#pragma unroll
    for (int r = 0; r < RT; ++r)
        *reinterpret_cast<float4*>(part + (us * RT + r) * H + 4 * kq) =
            make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
    __syncthreads();
    const int k = threadIdx.x;
    float* dst = remote_shared(recv_next, k / UB)
                 + ((size_t)rank * R + r0) * UB + k % UB;
#pragma unroll
    for (int r = 0; r < RT; ++r) {
        if (r < rows) {
            float v = part[r * H + k];
#pragma unroll
            for (int q = 1; q < 4; ++q) v += part[(q * RT + r) * H + k];
            dst[r * UB] = v;
        }
    }
    __syncthreads();  // part is used again
}

// KW > 0 is the kernel for H = kSplits * KW with the W values of the dh_prev
// product in registers, KW = 0 the kernel for any H. The gate recompute
// (and at KW = 0 the dh_prev product) reads the W slice from shared memory,
// or, where w_glob is given, from device memory (w_layout_kernel).
template <int L, typename XT, typename WT, int KW>
__global__ void __launch_bounds__(kThreads, 1)
lstm_bwd_kernel(const XT* __restrict__ xw, const WT* __restrict__ w_hh,
                const XT* __restrict__ out, const float* __restrict__ c_seq,
                const XT* __restrict__ d_out, const float* __restrict__ d_hT,
                const float* __restrict__ d_cT, float* __restrict__ d_xw,
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
    const int tid = threadIdx.x;

    const BwdLayout lay(R, H, sizeof(XT), w_glob != nullptr);
    const int RU = align16(R * UB * 4) / 4;  // floats of an [R][UB] region
    float4* w_s = reinterpret_cast<float4*>(smem + lay.w);
    // the products' W slice: in shared memory, or in device memory
    const float4* w_src = w_glob ? w_global_slice(w_glob, d, rank, H) : w_s;
    float* h_s = reinterpret_cast<float*>(smem + lay.h);
    float4* part = reinterpret_cast<float4*>(smem + lay.part);
    // where out[s-1] lands: over h_s, in its upper half when XT is bf16
    XT* hx = reinterpret_cast<XT*>(smem + lay.h) + (sizeof(XT) == 4 ? 0 : R * H);
    XT* xs = reinterpret_cast<XT*>(smem + lay.xs);
    char* dout_s = smem + lay.dout;
    float* cb = reinterpret_cast<float*>(smem + lay.cb);
    // a step's gate pre-activations, which its dgates then replace
    float4* dg = reinterpret_cast<float4*>(smem + lay.dg);
    float* dc_s = reinterpret_cast<float*>(smem + lay.dc);
    float* recv = reinterpret_cast<float*>(smem + lay.recv);
    const bool vec = (UB * sizeof(XT)) % 16 == 0;

    float4 w_d[KW > 0 ? KW : 1];  // the dh_prev product's (dh_product_reg)
    if constexpr (KW > 0) {
        const int kq = tid % (H / 4), us = tid / (H / 4);
        const WT* base = w_hh + ((size_t)d * H + 4 * kq) * 4 * H + u0
                         + us * (KW / 4);
#pragma unroll
        for (int e = 0; e < KW; ++e) {
            const WT* row = base + (size_t)(e % 4) * 4 * H + e / 4;
            w_d[e] = make_float4(to_f32(row[0]), to_f32(row[H]),
                                 to_f32(row[2 * H]), to_f32(row[3 * H]));
        }
    }

    auto dout_at = [&](int s) {
        return reinterpret_cast<XT*>(dout_s + (s & 1) * RU * 4);
    };
    auto c_at = [&](int s) { return cb + (s % 3) * RU; };
    auto stage_c = [&](int s) {  // c_seq[s], this block's units
        stage_segments(c_at(s), R, UB, vec, [&](int i) {
            return c_seq + (((size_t)s * 2 + d) * B + b0 + i) * H + u0;
        });
    };
    // What step s needs from device memory: xw[s] and d_out[s] of this
    // block's units, and for s > 0 h_prev = out[s-1] (all H) and c_seq[s-1].
    auto stage = [&](int s) {
        if (s >= 0) {
            stage_segments(xs, R * 4, UB, vec, [&](int i) {
                return xw + xw_row<L>(s, d, b0 + i / 4, T, B, H) + (i % 4) * H + u0;
            });
            stage_segments(dout_at(s), R, UB, vec, [&](int i) {
                return d_out + out_row<L>(s, d, b0 + i, T, B, H) + u0;
            });
        }
        if (s > 0) {
            stage_segments(hx, R, H, vec, [&](int i) {
                return out + out_row<L>(s - 1, d, b0 + i, T, B, H);
            });
            stage_c(s - 1);
        }
        cp_async_commit();
    };
    // The gate pre-activations of step s into `dg`, from what stage(s)
    // brought: xw[s] + round_WT(h_prev) @ W_hh (h_prev is zero at s = 0).
    auto recompute = [&](int s) {
        if (s > 0) widen_in_place<XT, WT>(h_s, hx, R * H);
        for (int r0 = 0; r0 < R; r0 += kTile) {
            const int rows = min(kTile, R - r0), rt = tile_rows(rows);
            if (s > 0) {
                gate_product_rows(w_src, h_s + r0 * H, part, rows, UB, H);
                __syncthreads();
            }
            for (int p = tid; p < rows * UB; p += blockDim.x) {
                const int tr = p / UB, u = p % UB, r = r0 + tr;
                float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
                if (s > 0) a = gate_sum(part, rt, tr, u, UB);
                const XT* x = xs + r * 4 * UB + u;
                dg[r * UB + u] =
                    make_float4(to_f32(x[0]) + a.x, to_f32(x[UB]) + a.y,
                                to_f32(x[2 * UB]) + a.z, to_f32(x[3 * UB]) + a.w);
            }
            __syncthreads();
        }
    };

    stage_c(T - 1);
    stage(T - 1);
    if (w_glob == nullptr)
        load_w_slice(w_s, w_hh + (size_t)d * H * 4 * H, H, UB, u0);
    for (int e = tid; e < R * UB; e += blockDim.x)
        dc_s[e] = d_cT[((size_t)d * B + b0 + e / UB) * H + u0 + e % UB];
    cp_async_wait<0>();  // stage(T-1) and c_seq[T-1] have landed
    cluster_sync();  // every block runs before any writes into another
    recompute(T - 1);
    stage(T - 2);

    for (int m = 0; m < T; ++m) {
        const int s = T - 1 - m;
        // the chain: dh and dc -> the four dgates of this block's units
        const float* recv_cur = recv + (m & 1) * kClusterBlocks * RU;
        const XT* dout_cur = dout_at(s);
        const float* c_now = c_at(s);
        const float* c_before = c_at(s - 1 + 3);
        for (int p = tid; p < R * UB; p += blockDim.x) {
            const int r = p / UB, u = p % UB;
            const int row = b0 + r, unit = u0 + u;
            const float4 a = dg[p];
            const float gi = sigmoid(a.x), gf = sigmoid(a.y);
            const float gg = tanhf(a.z), go = sigmoid(a.w);
            const float c_t = c_now[p];
            const float c_p = s > 0 ? c_before[p] : 0.0f;
            float dh_in;
            if (m == 0) {
                dh_in = d_hT[((size_t)d * B + row) * H + unit];
            } else {
                dh_in = recv_cur[p];
                for (int j = 1; j < kClusterBlocks; ++j)
                    dh_in += recv_cur[j * R * UB + p];
            }
            const float dh = dh_in + to_f32(dout_cur[p]);
            const float tc = tanhf(c_t);
            const float dc = dc_s[p] + dh * go * (1.0f - tc * tc);
            const float dgi = dc * gg * gi * (1.0f - gi);
            const float dgf = dc * c_p * gf * (1.0f - gf);
            const float dgg = dc * gi * (1.0f - gg * gg);
            const float dgo = dh * tc * go * (1.0f - go);
            float* dst = d_xw + xw_row<L>(s, d, row, T, B, H) + unit;
            dst[0] = dgi;
            dst[H] = dgf;
            dst[2 * H] = dgg;
            dst[3 * H] = dgo;
            dg[p] = make_float4(round_to<WT>(dgi), round_to<WT>(dgf),
                                round_to<WT>(dgg), round_to<WT>(dgo));
            dc_s[p] = dc * gf;
        }
        if (s == 0) break;  // the first step's dh_prev is never used
        __syncthreads();
        float* recv_next = recv + ((m + 1) & 1) * kClusterBlocks * RU;
        for (int r0 = 0; r0 < R; r0 += kTile) {
            const int rows = min(kTile, R - r0);
            float* part_f = reinterpret_cast<float*>(part);
            if constexpr (KW > 0) {
                if (tile_rows(rows) == kTile)
                    dh_product_reg<kTile>(w_d, dg + r0 * UB, part_f, recv_next,
                                          rank, r0, rows, R);
                else
                    dh_product_reg<kTile / 2>(w_d, dg + r0 * UB, part_f,
                                              recv_next, rank, r0, rows, R);
            } else if (tile_rows(rows) == kTile) {
                dh_product<kTile>(w_src, dg + r0 * UB, recv_next, rank, r0,
                                  rows, R, H, UB);
            } else {
                dh_product<kTile / 2>(w_src, dg + r0 * UB, recv_next, rank, r0,
                                      rows, R, H, UB);
            }
        }
        cluster_arrive();
        // off the chain, while the partials travel: the next step's gates,
        // then the fetch of what the step after it needs
        cp_async_wait<0>();  // stage(s-1) has landed
        __syncthreads();
        recompute(s - 1);
        stage(s - 2);
        cluster_wait();
    }
    cluster_sync();  // no block leaves while another may still write into it
}

// d_w_hh[d] = sum over steps s >= 1 and batch rows b of
//   round_WT(out[s-1, d, b, :])^T (x) round_WT(d_xw[s, d, b, :]).
// What bounds it on an H100: 2 * 2*P*H*4H operations, 8.5 GFLOP at T=128,
// B=64, H=256 (0.127 ms at the 67 TFLOP/s f32 peak), against 84 MB of
// operands read once (25 us at 3.35 TB/s): bound by operations. A product
// whose contraction (the P pairs) is 30 times its output's edge gives too
// few output tiles to fill 132 SMs, so the pairs are split as well:
// tile (d, kt, ct) is owned by a cluster of S blocks, block `rank` of it
// takes the pairs slice_rows(P, S, rank), walked kWgDepth at a time through
// a ring of kWgStages stages filled by cp.async (zero bytes past the pairs
// or the edges; a thread's rows followed by cursors, not divisions), the
// stage's barrier the only one; with bf16 weights each thread rounds the
// values it copied once they have landed, before that barrier. Two blocks
// share an SM; an NVIDIA H100 80GB HBM3 holds 30 clusters of 8 such blocks
// (its GPCs leave SMs over), so the 32 tiles at H=256 take S = 7, 224
// blocks in one wave (ops/lstm_scan._weight_grad_plan). Thread (ty, tx)
// keeps the 8 x 8 outputs rows 4ty + {0..3}, 64 + 4ty + {0..3} and the same
// columns with tx: four 16-byte loads from shared memory feed 64 multiply-adds, and
// a warp (4 ty x 8 tx) reads 64 and 128 contiguous bytes a load. Each block
// then writes its partial tile over its ring, and after the cluster barrier
// block `rank` adds the S partials of its 1/S of the tile in rank order,
// from the other blocks' shared memory, and stores the sums.
constexpr int kWgTile = 128;    // output tile edge (rows k, columns c)
constexpr int kWgDepth = 16;    // (s, b) pairs a stage
constexpr int kWgStages = 6;    // stages of the ring
constexpr int kWgMaxSplits = 8; // blocks of a cluster: the portable maximum
// the ring of f32 operands, over which the partial tile is written after it
constexpr int kWgSmem =
    kWgStages * kWgDepth * kWgTile * 2 * (int)sizeof(float);
static_assert(kWgTile * kWgTile * sizeof(float) <= kWgSmem, "the partial tile");
static_assert(kThreads * 64 == kWgTile * kWgTile, "8 x 8 outputs a thread");

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// The pair q = (s - 1) * B + b (step s >= 1, batch row b), walked forward
// without a division.
struct PairCursor {
    int s, b;
    PairCursor() = default;
    __device__ PairCursor(int q, int B) : s(1 + q / B), b(q % B) {}
    __device__ void advance(int n, int B) {
        for (b += n; b >= B; b -= B) ++s;
    }
};

template <int L, typename XT, typename WT>
__global__ void __launch_bounds__(kThreads, 2)
lstm_weight_grad_kernel(const XT* __restrict__ out,
                        const float* __restrict__ d_xw,
                        float* __restrict__ d_w_hh, int T, int B, int H,
                        int splits) {
    extern __shared__ float4 smem4[];
    constexpr int kStageElems = kWgDepth * kWgTile;
    // [stage][pair][k] h_prev as XT, then [stage][pair][c] dgates as f32
    XT* a_ring = reinterpret_cast<XT*>(smem4);
    float* b_ring = reinterpret_cast<float*>(a_ring + kWgStages * kStageElems);
    float* part = reinterpret_cast<float*>(smem4);  // [k][c], after the loop
    const int H4 = 4 * H, KT = cdiv(H, kWgTile), CT = cdiv(H4, kWgTile);
    const int rank = cluster_rank(), tile = blockIdx.x / splits;
    const int d = tile / (KT * CT);
    const int k0 = tile / CT % KT * kWgTile, c0 = tile % CT * kWgTile;
    int q0, nq;  // this block's pairs [q0, q0 + nq)
    slice_rows(T > 1 ? (T - 1) * B : 0, splits, rank, q0, nq);
    const int stages = cdiv(nq, kWgDepth);
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int ty = (warp >> 1) * 4 + (lane >> 3);
    const int tx = (warp & 1) * 8 + (lane & 7);

    // A thread copies the same chunk of NA rows of h_prev and NB rows of
    // dgates each stage: rows tid / AC + u * (kThreads / AC) of the stage,
    // and the same with BC, whose pairs its cursors follow.
    constexpr int AE = 16 / sizeof(XT), AC = kWgTile / AE, BC = kWgTile / 4;
    constexpr int NA = kWgDepth * AC / kThreads, NB = kWgDepth * BC / kThreads;
    static_assert(NA * kThreads == kWgDepth * AC
                      && NB * kThreads == kWgDepth * BC,
                  "whole rounds of 16-byte chunks");
    PairCursor ca[NA], cb[NB];
#pragma unroll
    for (int u = 0; u < NA; ++u)
        ca[u] = PairCursor(q0 + (tid + u * kThreads) / AC, B);
#pragma unroll
    for (int u = 0; u < NB; ++u)
        cb[u] = PairCursor(q0 + (tid + u * kThreads) / BC, B);
    // stage st (called for st = 0, 1, ... in turn) into ring slot `slot`:
    // zero bytes past the block's pairs and past H or 4H
    auto load_stage = [&](int st, int slot) {
        XT* a_s = a_ring + slot * kStageElems;
        float* b_s = b_ring + slot * kStageElems;
#pragma unroll
        for (int u = 0; u < NA; ++u) {
            const int e = tid + u * kThreads, p = e / AC, k = k0 + e % AC * AE;
            const bool ok = st * kWgDepth + p < nq && k < H;
            const XT* src =
                ok ? out + out_row<L>(ca[u].s - 1, d, ca[u].b, T, B, H) + k
                   : out;
            cp_async16(a_s + p * kWgTile + e % AC * AE, src, ok);
            ca[u].advance(kWgDepth, B);
        }
#pragma unroll
        for (int u = 0; u < NB; ++u) {
            const int e = tid + u * kThreads, p = e / BC, c = c0 + e % BC * 4;
            const bool ok = st * kWgDepth + p < nq && c < H4;
            const float* src =
                ok ? d_xw + xw_row<L>(cb[u].s, d, cb[u].b, T, B, H) + c
                   : d_xw;
            cp_async16(b_s + p * kWgTile + e % BC * 4, src, ok);
            cb[u].advance(kWgDepth, B);
        }
    };
    // with bf16 weights, the f32 values this thread copied into ring slot
    // `slot`, rounded to WT in place once they have landed
    auto round_stage = [&](int slot) {
        if constexpr (sizeof(XT) == sizeof(float)) {
            float* a_s = reinterpret_cast<float*>(a_ring) + slot * kStageElems;
#pragma unroll
            for (int u = 0; u < NA; ++u) {
                const int e = tid + u * kThreads;
                float4* v = reinterpret_cast<float4*>(a_s + e / AC * kWgTile
                                                      + e % AC * AE);
                *v = round_to<WT>(*v);
            }
        }
        float* b_s = b_ring + slot * kStageElems;
#pragma unroll
        for (int u = 0; u < NB; ++u) {
            const int e = tid + u * kThreads;
            float4* v = reinterpret_cast<float4*>(b_s + e / BC * kWgTile
                                                  + e % BC * 4);
            *v = round_to<WT>(*v);
        }
    };

    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

#pragma unroll
    for (int st = 0; st < kWgStages - 1; ++st) {
        if (st < stages) load_stage(st, st);
        cp_async_commit();
    }
    for (int st = 0; st < stages; ++st) {
        cp_async_wait<kWgStages - 2>();  // stage st has landed ...
        if constexpr (sizeof(WT) < sizeof(float)) round_stage(st % kWgStages);
        __syncthreads();  // ... for every thread, and slot st - 1 is free
        const int next = st + kWgStages - 1;
        if (next < stages) load_stage(next, next % kWgStages);
        cp_async_commit();
        const XT* a_s = a_ring + st % kWgStages * kStageElems;
        const float* b_s = b_ring + st % kWgStages * kStageElems;
#pragma unroll
        for (int p = 0; p < kWgDepth; ++p) {
            const float4 a0 = load4(a_s + p * kWgTile + 4 * ty);
            const float4 a1 = load4(a_s + p * kWgTile + 64 + 4 * ty);
            const float4 b0 = load4(b_s + p * kWgTile + 4 * tx);
            const float4 b1 = load4(b_s + p * kWgTile + 64 + 4 * tx);
            const float ak[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
            const float bk[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
            for (int i = 0; i < 8; ++i)
#pragma unroll
                for (int j = 0; j < 8; ++j)
                    acc[i][j] = fmaf(ak[i], bk[j], acc[i][j]);
        }
    }
    cp_async_wait<0>();
    __syncthreads();  // the ring is read: the partial tile takes its room
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        float* row = part + ((i < 4 ? 0 : 60) + 4 * ty + i) * kWgTile;
        *reinterpret_cast<float4*>(row + 4 * tx) =
            make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
        *reinterpret_cast<float4*>(row + 64 + 4 * tx) =
            make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
    }
    cluster_sync();  // every partial tile of the cluster is written
    constexpr int kRowF4 = kWgTile / 4;
    int e0, ne;  // this block's float4 of the tile
    slice_rows(kWgTile * kRowF4, splits, rank, e0, ne);
    float4* part4 = reinterpret_cast<float4*>(part);
    for (int e = e0 + tid; e < e0 + ne; e += kThreads) {
        const int k = k0 + e / kRowF4, c = c0 + e % kRowF4 * 4;
        if (k >= H || c >= H4) continue;
        float4 v = remote_shared(part4, 0)[e];
        for (int j = 1; j < splits; ++j) {  // rank order
            const float4 w = remote_shared(part4, j)[e];
            v.x += w.x;
            v.y += w.y;
            v.z += w.z;
            v.w += w.w;
        }
        *reinterpret_cast<float4*>(d_w_hh + ((size_t)d * H + k) * H4 + c) = v;
    }
    cluster_sync();  // no block leaves while another may still read it
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
    float4* w_glob;  // null, or the device-memory slices (w_layout_kernel)
    int T, B, H, n_slices, wg_splits;
};

int max_rows(int H, int smem_limit, int x_bytes, bool w_global) {
    int R = 0;
    while (BwdLayout(R + 1, H, x_bytes, w_global).total <= smem_limit) ++R;
    return R;
}

// One cluster of `splits` blocks a 128 x 128 tile of d_w_hh [2, H, 4H].
template <int L, typename XT, typename WT>
cudaError_t launch_weight_grad(const void* out, const float* d_xw,
                               float* d_w_hh, int T, int B, int H, int splits,
                               cudaStream_t st) {
    if (H % kClusterBlocks || splits < 1 || splits > kWgMaxSplits)
        return cudaErrorInvalidValue;
    auto kernel = lstm_weight_grad_kernel<L, XT, WT>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kWgSmem);
    if (err != cudaSuccess) return err;
    const int tiles = 2 * cdiv(H, kWgTile) * cdiv(4 * H, kWgTile);
    const ClusterLaunch cl(tiles, splits, kWgSmem, st);
    err = cudaLaunchKernelEx(&cl.cfg, kernel, static_cast<const XT*>(out),
                             d_xw, d_w_hh, T, B, H, splits);
    if (err != cudaSuccess) return err;
    return cudaGetLastError();
}

// The recurrence, then (with a d_w_hh to fill) the weight gradient.
template <int L, typename XT, typename WT>
cudaError_t launch(BwdArgs a, cudaStream_t st) {
    auto kernel = a.H == kRegH ? lstm_bwd_kernel<L, XT, WT, kRegK>
                               : lstm_bwd_kernel<L, XT, WT, 0>;
    if (a.n_slices < 1 || a.n_slices > a.B || a.H % kClusterBlocks
        || (a.w_glob && a.H == kRegH))
        return cudaErrorInvalidValue;
    const int rows = (a.B + a.n_slices - 1) / a.n_slices;
    const int smem = BwdLayout(rows, a.H, sizeof(XT), a.w_glob != nullptr).total;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    if (a.w_glob) {
        err = launch_w_layout(static_cast<const WT*>(a.w_hh), a.w_glob, a.H,
                              st);
        if (err != cudaSuccess) return err;
    }
    ClusterLaunch cl(2 * a.n_slices, kClusterBlocks, smem, st);
    err = cudaLaunchKernelEx(
        &cl.cfg, kernel, static_cast<const XT*>(a.xw),
        static_cast<const WT*>(a.w_hh), static_cast<const XT*>(a.out), a.c_seq,
        static_cast<const XT*>(a.d_out), a.d_hT, a.d_cT, a.d_xw,
        static_cast<const float4*>(a.w_glob), a.T, a.B, a.H, a.n_slices);
    if (err != cudaSuccess) return err;
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    return launch_weight_grad<L, XT, WT>(a.out, a.d_xw, a.d_w_hh, a.T, a.B,
                                         a.H, a.wg_splits, st);
}

// Calls f.template operator()<L, XT, WT>() for the codes, or reports them
// invalid: the flat layout takes xw and w_hh both f32 or both bf16.
template <typename F>
cudaError_t dispatch(int layout, int x_dtype, int w_dtype, F f) {
    std::integral_constant<int, kFlat> flat;
    if (layout == kFlat && x_dtype == kF32 && w_dtype == kF32)
        return f(flat, float{}, float{});
    if (layout == kFlat && x_dtype == kBF16 && w_dtype == kBF16)
        return f(flat, bf16{}, bf16{});
    if (layout != kStacked) return cudaErrorInvalidValue;
    std::integral_constant<int, kStacked> stacked;
    if (x_dtype == kF32 && w_dtype == kF32) return f(stacked, float{}, float{});
    if (x_dtype == kF32 && w_dtype == kBF16) return f(stacked, float{}, bf16{});
    if (x_dtype == kBF16 && w_dtype == kF32) return f(stacked, bf16{}, float{});
    if (x_dtype == kBF16 && w_dtype == kBF16) return f(stacked, bf16{}, bf16{});
    return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// The most rows one cluster of the backward recurrence holds at width H,
// with xw, out and d_out in elements of x_bytes bytes, within smem_limit
// bytes of dynamic shared memory a block (0 when not even one row fits),
// with the W slice in shared memory or (w_global) in device memory.
int svtsg_lstm_bwd_max_rows(int H, int smem_limit, int x_bytes, int w_global) {
    return max_rows(H, smem_limit, x_bytes, w_global);
}

// As svtsg_lstm_active_clusters, for the backward recurrence. Every
// instantiation of a storage size shares the shared memory BwdLayout gives
// for these arguments, takes no static shared memory, and fits one block an
// SM by registers (__launch_bounds__(kThreads, 1): at most 255 a thread),
// so the f32 one stands for 4-byte storage and the stacked bf16-xw one for
// 2-byte storage, the flat bf16 layout (K4 at bf16) among them.
int svtsg_lstm_bwd_active_clusters(int H, int rows, int x_bytes, int w_global,
                                   int device) {
    const int smem = BwdLayout(rows, H, x_bytes, w_global).total;
    if (x_bytes == sizeof(float))
        return active_clusters(
            H == kRegH ? lstm_bwd_kernel<kFlat, float, float, kRegK>
                       : lstm_bwd_kernel<kFlat, float, float, 0>,
            smem, device);
    return active_clusters(
        H == kRegH ? lstm_bwd_kernel<kStacked, bf16, float, kRegK>
                   : lstm_bwd_kernel<kStacked, bf16, float, 0>,
        smem, device);
}

// Launch the backward recurrence and then the weight gradient on `stream`,
// over a batch of B rows cut into n_slices near-equal row slices, one
// cluster a (direction, slice), and the (step, row) pairs of the weight
// gradient cut into wg_splits, one block of a tile's cluster each. layout:
// kFlat (K4: xw and w_hh both f32 or both bf16) or kStacked (K6c);
// xw_dtype (xw, out, d_out) /
// w_dtype: kF32 or kBF16. w_glob as in svtsg_lstm_recurrence. Returns the
// CUDA error code (0 on success).
int svtsg_lstm_bwd(const void* xw, const void* w_hh, const void* out,
                   const float* c_seq, const void* d_out, const float* d_hT,
                   const float* d_cT, float* d_xw, float* d_w_hh, void* w_glob,
                   int T, int B, int H, int n_slices, int wg_splits,
                   int layout, int xw_dtype, int w_dtype, int device,
                   void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return err;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const BwdArgs a{xw, w_hh, out, c_seq, d_out, d_hT, d_cT, d_xw, d_w_hh,
                    static_cast<float4*>(w_glob), T, B, H, n_slices,
                    wg_splits};
    return dispatch(layout, xw_dtype, w_dtype, [&](auto l, auto x, auto w) {
        return launch<decltype(l)::value, decltype(x), decltype(w)>(a, st);
    });
}

// The weight gradient alone: d_w_hh [2, H, 4H] f32 from the forward's out
// (type x_dtype) and the backward's d_xw (f32), both rounded to w_dtype,
// the pairs cut into `splits`. Returns the CUDA error code (0 on success).
int svtsg_lstm_weight_grad(const void* out, const float* d_xw, float* d_w_hh,
                           int T, int B, int H, int splits, int layout,
                           int x_dtype, int w_dtype, int device,
                           void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return err;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    return dispatch(layout, x_dtype, w_dtype, [&](auto l, auto x, auto w) {
        return launch_weight_grad<decltype(l)::value, decltype(x), decltype(w)>(
            out, d_xw, d_w_hh, T, B, H, splits, st);
    });
}

// The clusters of `splits` blocks of the weight-gradient kernel (layout and
// dtypes as in svtsg_lstm_weight_grad) that `device` holds at once, or
// minus the CUDA error code.
int svtsg_lstm_weight_grad_active_clusters(int splits, int layout, int x_dtype,
                                           int w_dtype, int device) {
    if (splits < 1 || splits > kWgMaxSplits) return -(int)cudaErrorInvalidValue;
    int n = 0;
    const cudaError_t err =
        dispatch(layout, x_dtype, w_dtype, [&](auto l, auto x, auto w) {
            n = active_clusters(
                lstm_weight_grad_kernel<decltype(l)::value, decltype(x),
                                        decltype(w)>,
                kWgSmem, device, splits);
            return n < 0 ? (cudaError_t)-n : cudaSuccess;
        });
    return err != cudaSuccess ? -(int)err : n;
}

}  // extern "C"
