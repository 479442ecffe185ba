// quantize_apply: per-column symmetric int8 codes of an fp32 [M, N] matrix.
//
// Replaces the Pallas kernel `quantize_apply` (src/repro/kernels/quantize.py,
// `_kernel`): q = clip(rint(x * (1 / scale[col])), -127, 127).
// One thread per element over a grid-stride loop; neighbouring threads read
// neighbouring floats and write neighbouring bytes, so the pass streams at
// the memory rate, which bounds it (5 bytes moved per element, no reuse).
#include "common.cuh"

__global__ void quantize_apply_kernel(const float* __restrict__ x,
                                      const float* __restrict__ scale,
                                      int8_t* __restrict__ q,
                                      long long total, int n) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < total; i += stride) {
    const int col = static_cast<int>(i % n);
    const float inv = __fdiv_rn(1.0f, scale[col]);
    q[i] = requantize(x[i], inv);
  }
}

extern "C" int quantize_apply(const void* x, const void* scale, void* q,
                              long long m, int n, void* stream) {
  const long long total = m * n;
  if (total == 0) return 0;
  const int threads = 256;
  long long blocks = (total + threads - 1) / threads;
  if (blocks > 132 * 64) blocks = 132 * 64;
  quantize_apply_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(scale),
      static_cast<int8_t*>(q), total, n);
  return static_cast<int>(cudaGetLastError());
}
