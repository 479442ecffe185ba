// Shared pieces of the port's CUDA kernels: the plain-C error hook every
// library exports, and the fp32 epilogue tail both int8 kernels apply.
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
