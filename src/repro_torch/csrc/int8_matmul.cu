// int8_matmul: [M, K] int8 x [K, N] int8 -> int32, with the fused epilogue
// (f32(acc) * x_scale[m]) * w_scale[n] (+ bias[n]), act, optional requant.
//
// Replaces the Pallas kernel `int8_matmul` (src/repro/kernels/int8_matmul.py,
// `_kernel`). On the served shapes M is a batch (<= 32) and K is large
// (fc1: K = 32769), so the product is bound by streaming the weight matrix
// once from device memory, not by arithmetic. The TPU kernel carried its
// accumulator across a sequential K grid axis; here blocks run in parallel,
// so K is split across blocks instead:
//   * block (nt, kc, mt) owns 128 output columns, one K chunk of 128 and 16
//     rows; each thread owns one column n and accumulates 16 rows with
//     __dp4a over 4 packed k (neighbouring threads read neighbouring weight
//     bytes of one row, so weight loads coalesce);
//   * partial sums go to an int32 buffer with atomicAdd (integer addition,
//     so the result does not depend on the order blocks finish);
//   * the last block to finish an (nt, mt) tile, found with a per-tile
//     ticket counter, applies the epilogue to that tile. One launch per
//     layer; the caller passes a zeroed [M*N + tiles] int32 scratch buffer.
// Every index into [M, N] is 64-bit: the LM's per-position projections fold
// batch x positions into M, and M * N passes 2^31 (B = 16, S = 4096 and a
// 32000-word head is 2.1 G). M / 16 rides on gridDim.z, which caps it at
// 65,535 tiles; the wrapper refuses a larger M before launching.
//
// Prepacked weights (the autotuner's arena: [kp, np] zero-padded to whole
// tiles, scales and bias at length np) are read in place: `ldw` is the
// weight row stride (np), the K loop runs over x's logical K (the padded
// rows are zeros and would add nothing), and only the logical N columns are
// computed and written. With unpacked weights ldw == N.
#include "common.cuh"

constexpr int kBN = 128;   // threads per block = output columns per block
constexpr int kKC = 128;   // K chunk per block (multiple of 4)
constexpr int kMT = 16;    // rows per block

__global__ void __launch_bounds__(kBN)
int8_matmul_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                   const float* __restrict__ xs, const float* __restrict__ ws,
                   const float* __restrict__ bias, void* __restrict__ out,
                   int* __restrict__ acc, unsigned int* __restrict__ done,
                   int M, int K, int N, int ldw, int act, int requant,
                   float inv) {
  __shared__ __align__(16) int8_t xt[kMT][kKC];
  __shared__ bool is_last;
  const int n = blockIdx.x * kBN + threadIdx.x;
  const int k0 = blockIdx.y * kKC;
  const int m0 = blockIdx.z * kMT;

  // stage this block's x tile, zero past M and K (zeros add nothing)
  for (int i = threadIdx.x; i < kMT * kKC; i += kBN) {
    const int mm = i / kKC, kk = i % kKC;
    const int m = m0 + mm, k = k0 + kk;
    xt[mm][kk] = (m < M && k < K) ? x[static_cast<long long>(m) * K + k] : 0;
  }
  __syncthreads();

  if (n < N) {
    int a[kMT];
#pragma unroll
    for (int mm = 0; mm < kMT; ++mm) a[mm] = 0;
    for (int kk = 0; kk < kKC; kk += 4) {
      unsigned int wp = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k = k0 + kk + j;
        const int b = (k < K) ? w[static_cast<long long>(k) * ldw + n] : 0;
        wp |= static_cast<unsigned int>(b & 0xff) << (8 * j);
      }
      if (wp == 0) continue;
#pragma unroll
      for (int mm = 0; mm < kMT; ++mm) {
        const int xp = *reinterpret_cast<const int*>(&xt[mm][kk]);
        a[mm] = __dp4a(xp, static_cast<int>(wp), a[mm]);
      }
    }
#pragma unroll
    for (int mm = 0; mm < kMT; ++mm) {
      const int m = m0 + mm;
      if (m < M && a[mm] != 0)
        atomicAdd(&acc[static_cast<long long>(m) * N + n], a[mm]);
    }
  }

  // publish this block's partial sums, then take a ticket for the tile
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned int tile = blockIdx.z * gridDim.x + blockIdx.x;
    is_last = atomicAdd(&done[tile], 1u) == gridDim.y - 1;
  }
  __syncthreads();
  if (!is_last || n >= N) return;
  __threadfence();

  for (int mm = 0; mm < kMT; ++mm) {
    const int m = m0 + mm;
    if (m >= M) break;
    const long long idx = static_cast<long long>(m) * N + n;
    const float accf = __int2float_rn(__ldcg(&acc[idx]));
    const float p = __fmul_rn(accf, xs[m]);
    const float v = bias ? __fmaf_rn(p, ws[n], bias[n]) : __fmul_rn(p, ws[n]);
    store_epilogue(out, idx, v, act, requant, inv);
  }
}

extern "C" int int8_matmul(const void* x, const void* w, const void* xs,
                           const void* ws, const void* bias, void* out,
                           void* scratch, int M, int K, int N, int ldw,
                           int act, int requant, float inv, void* stream) {
  if (M == 0 || N == 0) return 0;
  const int nt = (N + kBN - 1) / kBN;
  const int kc = K > 0 ? (K + kKC - 1) / kKC : 1;
  const int mt = (M + kMT - 1) / kMT;
  int* acc = static_cast<int*>(scratch);
  unsigned int* done =
      reinterpret_cast<unsigned int*>(acc + static_cast<long long>(M) * N);
  dim3 grid(nt, kc, mt);
  int8_matmul_kernel<<<grid, kBN, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(xs), static_cast<const float*>(ws),
      static_cast<const float*>(bias), out, acc, done, M, K, N, ldw, act,
      requant, inv);
  return static_cast<int>(cudaGetLastError());
}

// scratch int32 words the caller must zero before the launch
extern "C" long long int8_matmul_scratch_words(int M, int N) {
  const int nt = (N + kBN - 1) / kBN;
  const int mt = (M + kMT - 1) / kMT;
  return static_cast<long long>(M) * N + static_cast<long long>(nt) * mt;
}
