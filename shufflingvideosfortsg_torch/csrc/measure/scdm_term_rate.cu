// The rate of scdm_fwd_mma_kernel's and scdm_bwd_bf16x2_kernel's term code
// alone, from registers: a measurement, not part of the kernel library
// (_kernels.SOURCES leaves it out). It includes scdm.cu, so it times the
// kernels' own device code (term_sum2, term_tanh2; bwd_term2).
// measure_scdm --term-rate builds and runs it.
#include "../scdm.cu"

namespace {

// MODE 0 runs term_tanh2(term_sum2(.)) on 8 independent bf16x2 chains a
// thread, MODE 1 only an ex2 and a reciprocal a term (the special-function
// pipe's share of tanh_fwd), MODE 2 the backward's bwd_term2 (its f32 sums
// into 8 words' two d_sent_proj sums, one row's two d_video_proj sums and
// d_w's two, as in the kernel's loop, plus one integer add a pair that
// moves the word's sent_proj); 16 terms a thread an iteration each.
template <int MODE>
__global__ void __launch_bounds__(kThreads, 2)
term_rate_kernel(unsigned* __restrict__ out, int iters) {
    unsigned s[8];
#pragma unroll
    for (int j = 0; j < 8; ++j)  // bf16 pairs in [0.125, 2)
        s[j] = 0x3e003e00u + ((threadIdx.x * 8 + j) & 0x3ff) * 0x00010001u;
    const unsigned d = 0x00010001u * (blockIdx.x & 3);
    unsigned acc = 0;
    float facc = 0.0f;
    float ds[16] = {}, dv0 = 0.0f, dv1 = 0.0f, dw0 = 0.0f, dw1 = 0.0f;
    const unsigned v2 = 0x3e803e80u ^ d;       // video_proj 0.25
    const unsigned g2 = 0x3c003c00u + d;        // dl ~2^-7
    const float g = __uint_as_float(g2 << 16);
    const unsigned w2 = 0x3d503d50u;            // w ~0.05
    for (int i = 0; i < iters; ++i) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            if constexpr (MODE == 0) {
                const unsigned a = term_tanh2(term_sum2(s[j], d));
                acc ^= a;
                s[j] ^= a & 0x00070007u;
            } else if constexpr (MODE == 2) {
                bwd_term2(v2, s[j], g2, g, w2, ds[2 * j], ds[2 * j + 1], dv0,
                          dv1, dw0, dw1);
                s[j] += 0x00010001u;
            } else {
                const float x0 = __uint_as_float(s[j] << 16);
                const float x1 = __uint_as_float(s[j] & 0xffff0000u);
                float e0, e1, r0, r1;
                asm volatile("ex2.approx.ftz.f32 %0, %1;" : "=f"(e0) : "f"(x0));
                asm volatile("ex2.approx.ftz.f32 %0, %1;" : "=f"(e1) : "f"(x1));
                asm volatile("rcp.approx.ftz.f32 %0, %1;" : "=f"(r0) : "f"(e0));
                asm volatile("rcp.approx.ftz.f32 %0, %1;" : "=f"(r1) : "f"(e1));
                facc += r0 + r1;
                s[j] += 0x00010001u;
            }
        }
    }
    if constexpr (MODE == 2) {
#pragma unroll
        for (int j = 0; j < 16; ++j) facc += ds[j];
        facc += dv0 + dv1 + dw0 + dw1;
    }
    out[blockIdx.x * blockDim.x + threadIdx.x] = acc ^ __float_as_uint(facc);
}

}  // namespace

// Launch term_rate_kernel<mode> (0: the bf16 forward's term code, 1: its
// ex2 and reciprocal alone, 2: the bf16 backward's term code) on `stream`,
// `blocks` blocks of kThreads threads, each thread 16 * iters terms; out
// receives one word a thread (blocks * kThreads). Returns the CUDA error
// code.
extern "C" int svtsg_scdm_term_rate(int mode, unsigned* out, int blocks,
                                    int iters, int device, void* stream) {
    if (blocks < 1 || iters < 1 || mode < 0 || mode > 2)
        return cudaErrorInvalidValue;
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return err;
    const auto kernel = mode == 0   ? term_rate_kernel<0>
                        : mode == 1 ? term_rate_kernel<1>
                                    : term_rate_kernel<2>;
    kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        out, iters);
    return cudaGetLastError();
}
