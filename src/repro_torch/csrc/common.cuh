// Shared pieces of the port's CUDA kernels: the plain-C error hook every
// library exports, the fp32 epilogue tail the int8 kernels apply, and the
// 3xTF32 split and TF32 mma that flash_attention, ssd and the fp32 conv
// use.
//
// Rounding contract (kernels/epilogue.py holds the plain PyTorch twin):
//   * every multiply and add is an explicit round-to-nearest intrinsic
//     (the build also passes -fmad=false), so nvcc cannot contract or
//     reassociate anything on its own;
//   * the bias add is fused with the last dequant multiply (__fmaf_rn),
//     as the reference's XLA backend does;
//   * requantize multiplies by the float32 reciprocal of the static scale
//     (the caller passes it), then rounds half to even (rintf).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

extern "C" const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

enum Act { ACT_NONE = 0, ACT_RELU = 1, ACT_SIGMOID = 2 };

__device__ __forceinline__ float apply_act(float v, int act) {
  if (act == ACT_RELU) return fmaxf(v, 0.0f);
  if (act == ACT_SIGMOID) return __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-v)));
  return v;
}

// clip(rint(v * inv), -127, 127) as int8
__device__ __forceinline__ int8_t requantize(float v, float inv) {
  float r = rintf(__fmul_rn(v, inv));
  r = fminf(fmaxf(r, -127.0f), 127.0f);
  return static_cast<int8_t>(r);
}

// The whole tail for one output element; writes int8 when requant != 0.
__device__ __forceinline__ void store_epilogue(void* out, long long idx,
                                               float v, int act,
                                               int requant, float inv) {
  v = apply_act(v, act);
  if (requant) {
    static_cast<int8_t*>(out)[idx] = requantize(v, inv);
  } else {
    static_cast<float*>(out)[idx] = v;
  }
}

// x = big + small: big is x truncated to TF32 (low 13 bits cleared),
// small = x - big exactly; the mma reads small's top 19 bits
__device__ __forceinline__ void split_tf32(float x, uint32_t& big,
                                           uint32_t& small) {
  big = __float_as_uint(x) & 0xffffe000u;
  small = __float_as_uint(__fsub_rn(x, __uint_as_float(big)));
}

// c (16 x 8, fp32) += a (16 x 8, tf32) x b (8 x 8, tf32)
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c[c0 + j] += a x b_j for eight column groups in 3xTF32, where b_j's
// two entries are (x[j], y[j]): the small terms of all eight first
template <int N>
__device__ __forceinline__ void mma8_3xtf32(float (&c)[N][4], int c0,
                                            const uint32_t (&ab)[4],
                                            const uint32_t (&as)[4],
                                            const float (&x)[8],
                                            const float (&y)[8]) {
  uint32_t bb[8][2], bs[8][2];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    split_tf32(x[j], bb[j][0], bs[j][0]);
    split_tf32(y[j], bb[j][1], bs[j][1]);
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) mma_tf32(c[c0 + j], as, bb[j][0], bb[j][1]);
#pragma unroll
  for (int j = 0; j < 8; ++j) mma_tf32(c[c0 + j], ab, bs[j][0], bs[j][1]);
#pragma unroll
  for (int j = 0; j < 8; ++j) mma_tf32(c[c0 + j], ab, bb[j][0], bb[j][1]);
}
