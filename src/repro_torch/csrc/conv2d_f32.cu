// conv2d_f32: NHWC float32 convolution, SAME/VALID, stride s, + bias,
// optional relu, in IEEE fp32 (FFMA with round-to-nearest; no TF32, no fast
// math, nothing from cuDNN).
//
// Replaces the Pallas kernel `conv2d` (src/repro/kernels/conv2d.py,
// `_kernel`), which held a whole padded image in VMEM and accumulated KH*KW
// shifted [W_out, Cin] x [Cin, Cout] matmuls per output row. The design
// follows csrc/conv2d_int8.cu:
//   * a block owns an 8 x 32 tile of output pixels of one image and bc
//     output channels (blockIdx.z = image * n_channel_blocks + channel
//     block); it stages the input patch the tile reads and its
//     [KH, KW, Cin, bc] filter slice into shared memory, producing the SAME
//     padding as zeros while staging (no padded copy of the input);
//   * each thread computes 4 neighbouring output channels of one pixel,
//     reading the input value once and the 4 weights as one float4;
//   * bc is at most 64 and is halved until patch and slice fit a block's
//     227 KB, so wide filters run as more channel blocks.
// The bound at the shapes it is timed at (the VAE stem, CNet's stem) is the
// fp32 rate of the CUDA cores for CNet's 48 channels and the memory
// traffic for the VAE's 8; this SIMT design reaches a fraction of either.
#include "common.cuh"

constexpr int kRH = 8;        // output rows per block
constexpr int kTW = 32;       // output columns per block
constexpr int kThreads = 256;
constexpr int kMaxBC = 64;    // output channels per block, at most
constexpr int kSmemLimit = 232448;

struct ConvF32Args {
  const float* x;
  const float* w;
  const float* bias;
  float* out;
  int B, H, W, Cin, Cout, KH, KW, stride, pad_top, pad_left, Ho, Wo;
  int bc, ncb, relu;
};

__host__ __device__ inline int patch_floats(int Cin, int KH, int KW,
                                            int stride) {
  const int ph = (kRH - 1) * stride + KH;
  const int pw = (kTW - 1) * stride + KW;
  return ((ph * pw * Cin) + 3) & ~3;   // keep the filter 16-byte aligned
}

static int smem_for(int Cin, int bc, int KH, int KW, int stride) {
  const int bcw = (bc + 3) & ~3;
  return 4 * (patch_floats(Cin, KH, KW, stride) + KH * KW * Cin * bcw);
}

__global__ void __launch_bounds__(kThreads) conv2d_f32_kernel(ConvF32Args a) {
  extern __shared__ __align__(16) float fsm[];
  const int ph = (kRH - 1) * a.stride + a.KH;
  const int pw = (kTW - 1) * a.stride + a.KW;
  const int bcw = (a.bc + 3) & ~3;
  const int ncg = bcw / 4;
  float* patch = fsm;
  float* wsm = fsm + patch_floats(a.Cin, a.KH, a.KW, a.stride);
  const int b = blockIdx.z / a.ncb;
  const int co0 = (blockIdx.z % a.ncb) * a.bc;
  const int ho0 = blockIdx.y * kRH;
  const int wo0 = blockIdx.x * kTW;

  // filter slice -> [tap][ci][bcw], zero past bc and past Cout
  const int wfl = a.KH * a.KW * a.Cin * bcw;
  for (int i = threadIdx.x; i < wfl; i += kThreads) {
    const int cl = i % bcw;
    const int row = i / bcw;            // tap * Cin + ci
    const int co = co0 + cl;
    wsm[i] = (cl < a.bc && co < a.Cout)
                 ? a.w[static_cast<long long>(row) * a.Cout + co]
                 : 0.0f;
  }
  // input patch [ph][pw][Cin]; SAME padding and tile overhang -> 0
  const int pfl = ph * pw * a.Cin;
  for (int i = threadIdx.x; i < pfl; i += kThreads) {
    const int ci = i % a.Cin;
    const int pix = i / a.Cin;
    const int pc = pix % pw;
    const int pr = pix / pw;
    const int hi = ho0 * a.stride - a.pad_top + pr;
    const int wi = wo0 * a.stride - a.pad_left + pc;
    float v = 0.0f;
    if (hi >= 0 && hi < a.H && wi >= 0 && wi < a.W)
      v = a.x[((static_cast<long long>(b) * a.H + hi) * a.W + wi) * a.Cin +
              ci];
    patch[i] = v;
  }
  __syncthreads();

  const int items = kRH * kTW * ncg;
  for (int it = threadIdx.x; it < items; it += kThreads) {
    const int cg = it % ncg;
    const int pix = it / ncg;
    const int rr = pix / kTW, cc = pix % kTW;
    const int ho = ho0 + rr, wo = wo0 + cc;
    if (ho >= a.Ho || wo >= a.Wo) continue;
    float acc0 = 0.0f, acc1 = 0.0f, acc2 = 0.0f, acc3 = 0.0f;
    for (int r = 0; r < a.KH; ++r) {
      for (int c = 0; c < a.KW; ++c) {
        const float* prow =
            patch + ((rr * a.stride + r) * pw + (cc * a.stride + c)) * a.Cin;
        const float4* wrow = reinterpret_cast<const float4*>(
                                 wsm + (r * a.KW + c) * a.Cin * bcw) + cg;
        for (int ci = 0; ci < a.Cin; ++ci) {
          const float xv = prow[ci];
          const float4 wv = wrow[ci * ncg];
          acc0 = __fmaf_rn(xv, wv.x, acc0);
          acc1 = __fmaf_rn(xv, wv.y, acc1);
          acc2 = __fmaf_rn(xv, wv.z, acc2);
          acc3 = __fmaf_rn(xv, wv.w, acc3);
        }
      }
    }
    const float accs[4] = {acc0, acc1, acc2, acc3};
    const long long base =
        ((static_cast<long long>(b) * a.Ho + ho) * a.Wo + wo) * a.Cout;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int cl = cg * 4 + j;
      const int co = co0 + cl;
      if (cl >= a.bc || co >= a.Cout) break;
      float v = a.bias ? __fadd_rn(accs[j], a.bias[co]) : accs[j];
      if (a.relu) v = fmaxf(v, 0.0f);
      a.out[base + co] = v;
    }
  }
}

// Output channels per block: min(round4(Cout), 64), halved (keeping a
// multiple of 4) until the block fits shared memory; 0 if 4 do not fit.
extern "C" int conv2d_f32_block_channels(int Cin, int Cout, int KH, int KW,
                                         int stride) {
  int bc = (Cout + 3) & ~3;
  if (bc > kMaxBC) bc = kMaxBC;
  while (bc > 4 && smem_for(Cin, bc, KH, KW, stride) > kSmemLimit)
    bc = ((bc / 2) + 3) & ~3;
  return smem_for(Cin, bc, KH, KW, stride) > kSmemLimit ? 0 : bc;
}

extern "C" int conv2d_f32(const void* x, const void* w, const void* bias,
                          void* out, int B, int H, int W, int Cin, int Cout,
                          int KH, int KW, int stride, int pad_top,
                          int pad_left, int Ho, int Wo, int bc, int relu,
                          void* stream) {
  if (B == 0 || Ho == 0 || Wo == 0 || Cout == 0) return 0;
  const int ncb = (Cout + bc - 1) / bc;
  ConvF32Args a{static_cast<const float*>(x), static_cast<const float*>(w),
                static_cast<const float*>(bias), static_cast<float*>(out),
                B, H, W, Cin, Cout, KH, KW, stride, pad_top, pad_left, Ho, Wo,
                bc, ncb, relu};
  const int smem = smem_for(Cin, bc, KH, KW, stride);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        conv2d_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  dim3 grid((Wo + kTW - 1) / kTW, (Ho + kRH - 1) / kRH, B * ncb);
  conv2d_f32_kernel<<<grid, kThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
