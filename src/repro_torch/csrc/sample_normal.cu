// sample_normal: the VAE's reparameterised sample z = mu + exp(0.5 logvar)
// * eps, eps drawn as jax.random.normal draws it from each sample's key.
//
// Replaces no Pallas kernel: the reference draws eps with XLA's RNG
// (jax.random.normal per sample key, src/repro/core/plan.py,
// `_sample_normal_b`). kernels/sample.py holds the plain PyTorch twin and
// the algorithm:
//   * element i of a sample's flat shape: (x0, x1) = threefry2x32(key,
//     (0, i)), 20 rounds; bits = x0 ^ x1 (every shift and add on
//     uint32_t);
//   * f = bitcast((bits >> 9) | 0x3F800000) - 1 in [0, 1);
//     u = max(lo, 2 f + lo), lo = nextafter(-1, 0);
//   * eps = sqrt(2) erfinv(u), erfinv as XLA lowers it for float32
//     (Giles' polynomial in w = -log1p(-u^2), Horner steps as FMAs).
//
// One thread per element, one launch. The work is tiny (the VAE draws 16
// samples of 6): ~100 integer operations and a few hundred bytes, so the
// launch is the floor; the design is only the simplest correct one.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr uint32_t kParity = 0x1BD11BDAu;

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1,
                                             uint32_t& x0, uint32_t& x1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ kParity};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x0 += x1;
      x1 = rotl(x1, rot[i % 2][j]) ^ x0;
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + static_cast<uint32_t>(i + 1);
  }
}

__device__ __forceinline__ float erfinv_xla(float x) {
  const float lt5[9] = {2.81022636e-08f,  3.43273939e-07f, -3.5233877e-06f,
                        -4.39150654e-06f, 0.00021858087f,  -0.00125372503f,
                        -0.00417768164f,  0.246640727f,    1.50140941f};
  const float ge5[9] = {-0.000200214257f, 0.000100950558f, 0.00134934322f,
                        -0.00367342844f,  0.00573950773f,  -0.0076224613f,
                        0.00943887047f,   1.00167406f,     2.83297682f};
  float w = -log1pf(__fmul_rn(x, -x));
  const bool lt = w < 5.0f;
  w = lt ? __fsub_rn(w, 2.5f) : __fsub_rn(__fsqrt_rn(w), 3.0f);
  float p = lt ? lt5[0] : ge5[0];
#pragma unroll
  for (int i = 1; i < 9; ++i) p = __fmaf_rn(p, w, lt ? lt5[i] : ge5[i]);
  if (fabsf(x) == 1.0f) return __fmul_rn(x, __int_as_float(0x7f800000));
  return __fmul_rn(p, x);
}

// keys: [B, 2] uint32 words; mu, logvar, out: [B, n] float32. eps_out,
// when not null, also receives each element's eps (the backward pass of
// the sample reads it: dlogvar = 0.5 g exp(0.5 logvar) eps). With
// bits_only the kernel writes each element's raw bits into out instead
// (mu and logvar unread): the card test holds them to the plain version.
__global__ void __launch_bounds__(kThreads)
    sample_normal_kernel(const float* __restrict__ mu,
                         const float* __restrict__ logvar,
                         const uint32_t* __restrict__ keys,
                         float* __restrict__ out,
                         float* __restrict__ eps_out, long long total,
                         long long n, int bits_only) {
  const long long e = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (e >= total) return;
  const long long b = e / n;
  uint32_t x0 = 0u;
  uint32_t x1 = static_cast<uint32_t>(e - b * n);
  threefry2x32(__ldg(keys + 2 * b), __ldg(keys + 2 * b + 1), x0, x1);
  const uint32_t bits = x0 ^ x1;
  if (bits_only) {
    out[e] = __uint_as_float(bits);
    return;
  }
  const float f = __fsub_rn(__uint_as_float((bits >> 9) | 0x3F800000u), 1.0f);
  const float lo = __uint_as_float(0xBF7FFFFFu);      // nextafter(-1, 0)
  const float u = fmaxf(lo, __fadd_rn(__fmul_rn(f, 2.0f), lo));
  const float sqrt2 = __uint_as_float(0x3FB504F3u);   // float32 sqrt(2)
  const float eps = __fmul_rn(sqrt2, erfinv_xla(u));
  if (eps_out != nullptr) eps_out[e] = eps;
  const float sd = expf(__fmul_rn(0.5f, logvar[e]));
  out[e] = __fadd_rn(mu[e], __fmul_rn(sd, eps));
}

}  // namespace

// b samples of n elements each; keys holds b (k0, k1) pairs; eps_out may
// be null
extern "C" int sample_normal(const void* mu, const void* logvar,
                             const void* keys, void* out, void* eps_out,
                             int b, long long n, int bits_only,
                             void* stream) {
  if (b <= 0 || n <= 0) return 0;
  if (n >= (1LL << 32)) return static_cast<int>(cudaErrorInvalidValue);
  const long long total = static_cast<long long>(b) * n;
  const long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  sample_normal_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(mu), static_cast<const float*>(logvar),
      static_cast<const uint32_t*>(keys), static_cast<float*>(out),
      static_cast<float*>(eps_out), total, n, bits_only);
  return static_cast<int>(cudaGetLastError());
}
