// quantize_apply: per-column symmetric int8 codes of an fp32 [M, N] matrix.
//
// Replaces the Pallas kernel `quantize_apply` (src/repro/kernels/quantize.py,
// `_kernel`): q = clip(rint(x * (1 / scale[col])), -127, 127), with the
// correctly rounded float32 reciprocal and rounding half to even.
//
// Bound by memory: 5 bytes move per element (4 in, 1 out) and nothing is
// reused, so the least time is the bytes over the HBM rate. The design
// keeps the instructions per element few and many bytes in flight:
//   * column-owned threads: a thread owns V consecutive columns for its
//     whole life and walks down the rows with a fixed step, so it forms
//     its V reciprocals once and the element loop has no division and no
//     modulo (one 32-bit division per thread picks its columns);
//   * V = 4 when N % 4 == 0, x is 16-byte and q 4-byte aligned (the
//     wrapper decides): one 16-byte load and one 4-byte store of four
//     codes per row; V = 1 otherwise;
//   * after its first row, U rows unrolled, their loads issued before any
//     store, so a thread has U loads in flight (evict-first: x is read
//     once);
//   * the grid is one resident wave, sized from the SM count and the
//     kernel's occupancy. Thread t takes column group t % G and first row
//     t / G, so the grid's first step reads one contiguous run (t * V
//     when N = G * V) and every step moves it S rows down;
//   * every element offset is 64-bit.
#include <algorithm>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxDevices = 64;

template <int V>
struct Row {
  float v[V];
};

template <int V>
__device__ __forceinline__ Row<V> load_row(const float* p) {
  Row<V> r;
  if constexpr (V == 4) {
    const float4 f = __ldcs(reinterpret_cast<const float4*>(p));
    r.v[0] = f.x;
    r.v[1] = f.y;
    r.v[2] = f.z;
    r.v[3] = f.w;
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j) r.v[j] = __ldcs(p + j);
  }
  return r;
}

template <int V>
__device__ __forceinline__ void store_row(int8_t* p, const Row<V>& r,
                                          const float (&inv)[V]) {
  if constexpr (V == 4) {
    uint32_t packed = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      packed |= static_cast<uint32_t>(
                    static_cast<uint8_t>(requantize(r.v[j], inv[j])))
                << (8 * j);
    }
    *reinterpret_cast<uint32_t*>(p) = packed;
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j) p[j] = requantize(r.v[j], inv[j]);
  }
}

// groups = N / V column groups, step = rows between a thread's rows; the
// grid holds at least groups * step threads (the rest return at once)
template <int V, int U>
__global__ void __launch_bounds__(kThreads)
    quantize_apply_kernel(const float* __restrict__ x,
                          const float* __restrict__ scale,
                          int8_t* __restrict__ q, long long m, int n,
                          unsigned groups, unsigned step) {
  const unsigned t = blockIdx.x * kThreads + threadIdx.x;
  const unsigned row0 = t / groups;
  if (row0 >= step) return;
  const int col = static_cast<int>(t - row0 * groups) * V;
  const long long stride = static_cast<long long>(step) * n;
  const long long start = static_cast<long long>(row0) * n + col;
  const float* xp = x + start;
  int8_t* qp = q + start;
  // the first row (row0 < step <= m) loads beside the scales, so the
  // reciprocals' wait on them does not delay it: at the smallest shapes a
  // thread has just this row
  float inv[V];
#pragma unroll
  for (int j = 0; j < V; ++j) inv[j] = __ldg(scale + col + j);
  const Row<V> first = load_row<V>(xp);
#pragma unroll
  for (int j = 0; j < V; ++j) inv[j] = __frcp_rn(inv[j]);
  store_row<V>(qp, first, inv);
  xp += stride;
  qp += stride;
  long long r = row0 + static_cast<long long>(step);
  for (; r + static_cast<long long>(U - 1) * step < m;
       r += static_cast<long long>(U) * step) {
    Row<V> rows[U];
#pragma unroll
    for (int u = 0; u < U; ++u) rows[u] = load_row<V>(xp + u * stride);
#pragma unroll
    for (int u = 0; u < U; ++u) store_row<V>(qp + u * stride, rows[u], inv);
    xp += U * stride;
    qp += U * stride;
  }
  for (; r < m; r += step) {
    store_row<V>(qp, load_row<V>(xp), inv);
    xp += stride;
    qp += stride;
  }
}

template <int V, int U>
int launch(const float* x, const float* scale, int8_t* q, long long m, int n,
           cudaStream_t stream) {
  // per device: SMs, and threads of this kernel one SM keeps resident
  static int sms[kMaxDevices] = {};
  static int resident_per_sm[kMaxDevices] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (resident_per_sm[dev] == 0) {
    int blocks_per_sm = 0;
    e = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount,
                               dev);
    if (e == cudaSuccess) {
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks_per_sm, quantize_apply_kernel<V, U>, kThreads, 0);
    }
    if (e != cudaSuccess) return static_cast<int>(e);
    resident_per_sm[dev] = std::max(blocks_per_sm, 1) * kThreads;
  }
  const long long resident =
      static_cast<long long>(sms[dev]) * resident_per_sm[dev];
  const long long groups = n / V;
  // rows between a thread's rows: as many threads as stay resident, at
  // most one per (row, column group); then the smallest step that needs
  // no more turns, so every thread walks the same number of rows (+-1)
  long long step = std::min(std::max(resident / groups, 1LL), m);
  const long long turns = (m + step - 1) / step;
  step = (m + turns - 1) / turns;
  const long long blocks = (groups * step + kThreads - 1) / kThreads;
  quantize_apply_kernel<V, U><<<static_cast<unsigned>(blocks), kThreads, 0,
                                stream>>>(
      x, scale, q, m, n, static_cast<unsigned>(groups),
      static_cast<unsigned>(step));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// vec != 0: four columns a thread (the caller checked N % 4 == 0 and the
// alignment of x and q; refused here otherwise)
extern "C" int quantize_apply(const void* x, const void* scale, void* q,
                              long long m, int n, int vec, void* stream) {
  if (m <= 0 || n <= 0) return 0;
  const float* xf = static_cast<const float*>(x);
  const float* sf = static_cast<const float*>(scale);
  int8_t* qi = static_cast<int8_t*>(q);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec) {
    if (n % 4 != 0 || reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
        reinterpret_cast<uintptr_t>(q) % 4 != 0) {
      return static_cast<int>(cudaErrorMisalignedAddress);
    }
    return launch<4, 4>(xf, sf, qi, m, n, s);
  }
  return launch<1, 8>(xf, sf, qi, m, n, s);
}
