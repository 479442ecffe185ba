// int8_matmul (split-K): [M, K] int8 x [K, N] int8 -> int32, with the fused
// epilogue (f32(acc) * x_scale[m]) * w_scale[n] (+ bias[n]), act, optional
// requant.
//
// Replaces the Pallas kernel `int8_matmul` (src/repro/kernels/int8_matmul.py,
// `_kernel`) where M is small and K long: CNet's fc1 ([16, 32769] x
// [32769, 92]) and head, the LM decode step's products with K > 2048, K
// below one wgmma step (`route` in kernels/int8_matmul.py picks; the tile
// kernel takes the rest). There the product is bound by streaming the
// weight matrix once from device memory (fc1: 3.0 MB, 0.9 us at 3.35
// TB/s), and that needs most of the matrix in flight at once. The TPU
// kernel carried its accumulator across a sequential K grid axis; here K
// is split across blocks instead:
//   * block (kb, nb, mb) owns 256 K rows, 128 output columns and 16 rows.
//     It issues its whole weight slice (32 KB at most) as cp.async copies
//     at once, 16 bytes each where the rows and the base allow: with one
//     column tile (N <= 128, row stride <= 128) the slice is one
//     contiguous run, copied flat whatever the row stride (fc1's 92-byte
//     rows); with several, each row's 128 columns, 16-byte copies when
//     the row stride is a multiple of 16, else 4-byte, else bytes;
//   * the 8 warps split the slice's K: warp w takes rows 4w..4w+3,
//     4w+32.., each lane 4 columns. A lane reads one 32-bit word of 4
//     columns from each of 4 rows, transposes them with __byte_perm into
//     4 column words of 4 k, and __dp4a's each against the 16 rows' x
//     words (broadcast from shared memory): 16 x 4 int32 sums a lane;
//   * the warps' sums meet in a shared [16][128] tile (shared atomics;
//     column 4l + c of a row at word 32c + l, so a warp's 32 lanes add
//     into 32 banks). A block alone on its K (K <= 256) applies the
//     epilogue from there;
//     otherwise it adds its tile into a persistent int32 scratch with
//     global atomics (integer addition: the result does not depend on the
//     order blocks finish) and takes a ticket; the last block of an
//     (nb, mb) tile applies the epilogue, writes zeros back over the sums
//     it consumed and resets its ticket. The scratch thus stays zero
//     between calls: the wrapper zeroes it once, when it allocates it, and
//     no call launches a memset.
// Every index into [M, N] is 64-bit (M * N passes 2^31 in the LM's
// folded shapes). M / 16 rides on gridDim.z, which caps it at 65,535 row
// tiles; the wrapper refuses a larger M before launching. N / 128 rides on
// gridDim.y (65,535 column tiles).
//
// Prepacked weights (the autotuner's arena: [kp, np] zero-padded to whole
// tiles, scales and bias at length np) are read in place: `ldw` is the
// weight row stride (np), the K loop runs over x's logical K (the padded
// rows are zeros and would add nothing), and only the logical N columns are
// computed and written. With unpacked weights ldw == N.
#include "common.cuh"

namespace {

constexpr int kMT = 16;        // rows per block
constexpr int kBN = 128;       // columns per block: 32 lanes x 4
constexpr int kKB = 256;       // K rows per block
constexpr int kWarps = 8;      // split the block's K in 4-row steps
constexpr int kThreads = 32 * kWarps;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// one G-byte piece from global to shared memory (cp.async for 16 and 4)
template <int G>
__device__ __forceinline__ void copy_piece(int8_t* dst, const int8_t* src) {
  if constexpr (G == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src)
                 : "memory");
  } else if constexpr (G == 4) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src)
                 : "memory");
  } else {
    *dst = *src;
  }
}

// `rows` runs of `len` bytes (source stride ld, destination stride ds) in
// G-byte pieces; the last piece of a run may read past `len`, up to the
// next multiple of G (the caller keeps that inside the buffer)
template <int G>
__device__ __forceinline__ void copy_runs(int8_t* dst, int ds,
                                          const int8_t* src, long long ld,
                                          int rows, int len) {
  const int per_row = (len + G - 1) / G;
  for (int i = threadIdx.x; i < rows * per_row; i += kThreads) {
    const int r = i / per_row, c = (i % per_row) * G;
    copy_piece<G>(dst + r * ds + c, src + r * ld + c);
  }
}

__device__ __forceinline__ void copy_runs_any(int g, int8_t* dst, int ds,
                                              const int8_t* src, long long ld,
                                              int rows, int len) {
  if (g == 16)
    copy_runs<16>(dst, ds, src, ld, rows, len);
  else if (g == 4)
    copy_runs<4>(dst, ds, src, ld, rows, len);
  else
    copy_runs<1>(dst, ds, src, ld, rows, len);
}

__device__ __forceinline__ void finish(void* out, const float* xs,
                                       const float* ws, const float* bias,
                                       int m, int n, long long idx, int acc,
                                       int act, int requant, float inv) {
  const float p = __fmul_rn(__int2float_rn(acc), xs[m]);
  const float v = bias ? __fmaf_rn(p, ws[n], bias[n]) : __fmul_rn(p, ws[n]);
  store_epilogue(out, idx, v, act, requant, inv);
}

// kWords: the weight tile's row stride is a multiple of 4, so a lane reads
// its 4 columns of a row as one word; else byte by byte
template <bool kWords>
__global__ void __launch_bounds__(kThreads)
int8_matmul_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                   const float* __restrict__ xs, const float* __restrict__ ws,
                   const float* __restrict__ bias, void* __restrict__ out,
                   int* __restrict__ acc, unsigned int* __restrict__ done,
                   int M, int K, int N, int ldw, int flat, int g, int act,
                   int requant, float inv) {
  __shared__ __align__(16) int8_t wt[kKB * kBN];
  __shared__ __align__(16) int8_t xt[kMT][kKB];
  __shared__ int part[kMT][kBN];   // column n at word 32 (n % 4) + n / 4
  __shared__ bool is_last;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int k0 = blockIdx.x * kKB;
  const int n0 = blockIdx.y * kBN;
  const int m0 = blockIdx.z * kMT;
  const int rows = min(kKB, K - k0);
  const int cols = min(kBN, N - n0);
  const int ss = flat ? ldw : kBN;   // the weight tile's row stride

  // the weight slice: every copy in flight at once
  if (flat) {
    const int len = rows * ldw;
    const int body = len - len % g;
    const int8_t* src = w + static_cast<long long>(k0) * ldw;
    copy_runs_any(g, wt, 0, src, 0, 1, body);
    copy_runs<1>(wt + body, 0, src + body, 0, 1, len - body);
  } else {
    copy_runs_any(g, wt, kBN, w + static_cast<long long>(k0) * ldw + n0, ldw,
                  rows, cols);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  // x rows m0.. and K rows k0.. (zeros past M and K: they add nothing)
  for (int i = tid; i < kMT * kKB; i += kThreads) {
    const int mm = i / kKB, kk = i % kKB, m = m0 + mm;
    xt[mm][kk] = (m < M && kk < rows)
                     ? x[static_cast<long long>(m) * K + k0 + kk] : 0;
  }
  for (int i = tid; i < kMT * kBN; i += kThreads) (&part[0][0])[i] = 0;
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();

  const int c0 = 4 * lane;
  if (c0 < cols) {
    int a[kMT][4];
#pragma unroll
    for (int mm = 0; mm < kMT; ++mm)
#pragma unroll
      for (int c = 0; c < 4; ++c) a[mm][c] = 0;
    for (int kk = 4 * warp; kk < rows; kk += 4 * kWarps) {
      uint32_t col[4];
      if constexpr (kWords) {
        const int8_t* p = wt + kk * ss + c0;
        const uint32_t r0 = *reinterpret_cast<const uint32_t*>(p);
        const uint32_t r1 = *reinterpret_cast<const uint32_t*>(p + ss);
        const uint32_t r2 = *reinterpret_cast<const uint32_t*>(p + 2 * ss);
        const uint32_t r3 = *reinterpret_cast<const uint32_t*>(p + 3 * ss);
        // col[c] = bytes c of r0, r1, r2, r3 (k order)
        const uint32_t lo01 = __byte_perm(r0, r1, 0x5140);
        const uint32_t hi01 = __byte_perm(r0, r1, 0x7362);
        const uint32_t lo23 = __byte_perm(r2, r3, 0x5140);
        const uint32_t hi23 = __byte_perm(r2, r3, 0x7362);
        col[0] = __byte_perm(lo01, lo23, 0x5410);
        col[1] = __byte_perm(lo01, lo23, 0x7632);
        col[2] = __byte_perm(hi01, hi23, 0x5410);
        col[3] = __byte_perm(hi01, hi23, 0x7632);
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          uint32_t v = 0;
          if (c0 + c < cols) {
#pragma unroll
            for (int j = 0; j < 4; ++j)
              v |= static_cast<uint32_t>(static_cast<uint8_t>(
                       wt[(kk + j) * ss + c0 + c]))
                   << (8 * j);
          }
          col[c] = v;
        }
      }
      if ((col[0] | col[1] | col[2] | col[3]) == 0) continue;
#pragma unroll
      for (int mm = 0; mm < kMT; ++mm) {
        if (m0 + mm < M) {
          const int xv = *reinterpret_cast<const int*>(&xt[mm][kk]);
#pragma unroll
          for (int c = 0; c < 4; ++c)
            a[mm][c] = __dp4a(xv, static_cast<int>(col[c]), a[mm][c]);
        }
      }
    }
#pragma unroll
    for (int mm = 0; mm < kMT; ++mm)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (a[mm][c] != 0) atomicAdd(&part[mm][32 * c + lane], a[mm][c]);
  }
  __syncthreads();

  if (gridDim.x == 1) {  // the block's sums are the whole K
    for (int i = tid; i < kMT * kBN; i += kThreads) {
      const int mm = i / kBN, nn = i % kBN, m = m0 + mm, n = n0 + nn;
      if (m < M && n < N)
        finish(out, xs, ws, bias, m, n, static_cast<long long>(m) * N + n,
               part[mm][32 * (nn % 4) + nn / 4], act, requant, inv);
    }
    return;
  }
  for (int i = tid; i < kMT * kBN; i += kThreads) {
    const int mm = i / kBN, nn = i % kBN, m = m0 + mm, n = n0 + nn;
    const int v = part[mm][32 * (nn % 4) + nn / 4];
    if (m < M && n < N && v != 0)
      atomicAdd(&acc[static_cast<long long>(m) * N + n], v);
  }
  // publish this block's sums, then take a ticket for the tile
  __threadfence();
  __syncthreads();
  const unsigned int tile = blockIdx.z * gridDim.y + blockIdx.y;
  if (tid == 0) is_last = atomicAdd(&done[tile], 1u) == gridDim.x - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  // every load of the tile's sums in flight before the first store
  constexpr int kPer = kMT * kBN / kThreads;
  int v[kPer];
#pragma unroll
  for (int e = 0; e < kPer; ++e) {
    const int i = tid + e * kThreads, m = m0 + i / kBN, n = n0 + i % kBN;
    v[e] = (m < M && n < N)
               ? __ldcg(&acc[static_cast<long long>(m) * N + n]) : 0;
  }
#pragma unroll
  for (int e = 0; e < kPer; ++e) {
    const int i = tid + e * kThreads, m = m0 + i / kBN, n = n0 + i % kBN;
    if (m < M && n < N) {
      const long long idx = static_cast<long long>(m) * N + n;
      __stcg(&acc[idx], 0);       // zero again for the next call
      finish(out, xs, ws, bias, m, n, idx, v[e], act, requant, inv);
    }
  }
  if (tid == 0) done[tile] = 0;
}

}  // namespace

// scratch: null when K <= 256 (one block per tile of K), else M * N + the
// number of (column, row) tiles int32 words, zero (the kernel leaves it
// zero again)
extern "C" int int8_matmul(const void* x, const void* w, const void* xs,
                           const void* ws, const void* bias, void* out,
                           void* scratch, int M, int K, int N, int ldw,
                           int act, int requant, float inv, void* stream) {
  if (M == 0 || N == 0) return 0;
  const int kc = K > 0 ? (K + kKB - 1) / kKB : 1;
  const int nt = (N + kBN - 1) / kBN;
  const int mt = (M + kMT - 1) / kMT;
  if (nt > 65535 || mt > 65535 || (kc > 1 && scratch == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  // one contiguous run per block when one column tile holds whole rows
  const int flat = nt == 1 && ldw <= kBN;
  const uintptr_t wa = reinterpret_cast<uintptr_t>(w);
  const int row_align = flat ? 16 : ldw;   // flat runs start at k0 * ldw
  const int g = (wa % 16 == 0 && row_align % 16 == 0) ? 16
                : (wa % 4 == 0 && row_align % 4 == 0) ? 4 : 1;
  int* acc = static_cast<int*>(scratch);
  unsigned int* done = reinterpret_cast<unsigned int*>(
      acc + (kc > 1 ? static_cast<long long>(M) * N : 0));
  dim3 grid(kc, nt, mt);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* xi = static_cast<const int8_t*>(x);
  const int8_t* wi = static_cast<const int8_t*>(w);
  const float* xsf = static_cast<const float*>(xs);
  const float* wsf = static_cast<const float*>(ws);
  const float* bf = static_cast<const float*>(bias);
  if (!flat || ldw % 4 == 0)
    int8_matmul_kernel<true><<<grid, kThreads, 0, s>>>(
        xi, wi, xsf, wsf, bf, out, acc, done, M, K, N, ldw, flat, g, act,
        requant, inv);
  else
    int8_matmul_kernel<false><<<grid, kThreads, 0, s>>>(
        xi, wi, xsf, wsf, bf, out, acc, done, M, K, N, ldw, flat, g, act,
        requant, inv);
  return static_cast<int>(cudaGetLastError());
}
