// int8_matmul, tile route: [M, K] int8 x [K, N] int8 -> int32 on the
// tensor cores, with the fused epilogue of common.cuh
// (f32(acc) * x_scale[m]) * w_scale[n] (+ bias[n]), act, optional requant.
//
// Replaces the Pallas kernel `int8_matmul` (src/repro/kernels/int8_matmul.py,
// `_kernel`) for large M and for small M with K <= 2048 (kernels/
// int8_matmul.py: route); csrc/int8_matmul.cu (split-K) keeps the rest.
// What bounds it on an H100: the LM's per-position projections fold batch x
// positions into M (8192 at a B=4 prefill), so the vocab head
// [8192, 2048] x [2048, 32000] is 1.07 T int8 operations against 0.3 GB of
// operands and 1 GB of fp32 output: the int8 tensor-core rate bounds it
// (1,979 TOP/s: 0.54 ms), not memory (0.39 ms).
//
// Design (what it does about the bound):
//   * one block of two warpgroups per 128 x 128 output tile; each warpgroup
//     issues `wgmma.mma_async m64n128k32 .s32.s8.s8` on its 64 rows, the
//     int32 sums stay in registers for the whole K loop (no atomics, no
//     scratch, no zeroing). For N <= 64 (the SSD's b/c/dt projections) a
//     block is one warpgroup on a 64 x 64 tile (m64n64k32), which doubles
//     the blocks and wastes no half-empty column tile;
//   * int8 wgmma takes both operands K-major from shared memory (the
//     transpose option exists only for 16-bit types). x [M, K] is K-major
//     already; the weights [K, N] (N contiguous) are the plan's one live
//     copy, so each [128 k, BN n] weight tile is copied as it lies and then
//     transposed in shared memory: a thread reads a 16 (k) x 4 (n) block
//     as 16 words and writes four 16-byte K-major rows (__byte_perm);
//   * the wgmma operands lie in the 128-byte swizzled K-major layout: each
//     128-deep row of a tile is 128 contiguous bytes, its 16-byte K chunk
//     c stored at chunk c ^ (row % 8), so a descriptor's stride offset
//     (next 8 rows) is 1024 bytes and a 32-deep K step moves its start by
//     32 bytes; eight threads copy one row of x (128 contiguous bytes) and
//     the swizzle spreads their stores, like the transposed weight rows',
//     over all eight bank groups;
//   * a ring of three stages fed by cp.async (16 bytes per copy,
//     zero-filled past M, K and ldw): while tile t is transposed and
//     multiplied, tiles t + 1 and t + 2 are in flight, with no registers
//     held for them; 113 KB per 128 x 128 block, two blocks per SM;
//   * ragged edges: rows past M and K past the logical K are staged as
//     zeros (a prepacked [kp, np] arena's padded rows are never read),
//     columns past N are computed and not stored. Where K or ldw is not a
//     multiple of 16 or a base is not 16-byte aligned, the same kernel
//     stages through byte loads and plain stores (the `kVec = false`
//     instance);
//   * the epilogue reads each accumulator fragment in place (warp w of a
//     warpgroup holds rows 16w..16w+15, as mma.sync's m16n8 C layout
//     repeated over the column groups) and applies store_epilogue's
//     arithmetic per element, so the result equals the plain version bit
//     for bit; the finished tile goes through shared memory, so the global
//     stores are whole 16-byte pieces of output rows;
//   * output tiles are laid on gridDim.x (up to 2^31 - 1 tiles), grouped 8
//     row tiles at a time so neighbouring blocks share weight columns in
//     L2; every [M, N] index is 64-bit.
#include "common.cuh"

#include <limits.h>

namespace {

constexpr int kBK = 128;          // K bytes per stage
constexpr int kGroupM = 8;        // row tiles per raster group

// The two tile shapes: WG warpgroups of 64 rows each by BN columns. The
// weight staging gives each thread a 16 (k) x 4 (n) block, so the block
// has 2 * BN threads: <2, 128> for the wide projections, <1, 64> for
// N <= 64 (the SSD's b/c/dt projections), where 128-column tiles would
// leave half of each tile and half of the SMs idle.
constexpr int kStages = 3;        // K tiles in flight: this one + 2 ahead

template <int WG, int BN>
struct Tile {
  static constexpr int kBM = 64 * WG;
  static constexpr int kThreads = 128 * WG;
  static constexpr int kStageA = kBM * kBK;     // x, swizzled
  static constexpr int kStage = kStageA + BN * kBK;  // + weights as loaded
  static constexpr int kTrans = BN * kBK;       // weights, K-major swizzled
  // 1024-byte aligned: 113 KB at <2, 128> (two blocks per SM)
  static constexpr int kSmem = kStages * kStage + kTrans + 1024;
  static_assert(2 * BN == kThreads, "one weight block per thread");
};

// One wgmma m64nNk32: d (s32) += A (s8, 64 x 32) x B (s8, 32 x N), both
// operands K-major in shared memory (descriptors da, db).
__device__ __forceinline__ void wgmma_n128(int (&d)[64], uint64_t da,
                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
        "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_n64(int (&d)[32], uint64_t da,
                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

template <int BN>
__device__ __forceinline__ void wgmma(int (&d)[BN / 2], uint64_t da,
                                      uint64_t db) {
  if constexpr (BN == 128) {
    wgmma_n128(d, da, db);
  } else {
    wgmma_n64(d, da, db);
  }
}

// Shared-memory matrix descriptor of a K-major tile in the 128-byte
// swizzle (layout type 1): 8-row groups 1024 bytes apart.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

// byte offset of row r's 16-byte K chunk c in a swizzled tile
__device__ __forceinline__ int swz(int r, int c) {
  return r * 128 + ((c ^ (r % 8)) * 16);
}

template <int R>
__device__ __forceinline__ void fence_operands(int (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// byte j of each of four words a0..a3, packed low to high
__device__ __forceinline__ uint32_t column_bytes(uint32_t a0, uint32_t a1,
                                                 uint32_t a2, uint32_t a3,
                                                 uint32_t sel) {
  return __byte_perm(__byte_perm(a0, a1, sel), __byte_perm(a2, a3, sel),
                     0x5410);
}

// 16 bytes from global to shared memory, zero-filled when !in
__device__ __forceinline__ void cp_async16(int8_t* dst, const int8_t* src,
                                           bool in) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(in ? 16 : 0)
               : "memory");
}

// One K tile into a stage: x rows [m0, m0 + kBM) x K [k0, k0 + 128) into
// the swizzled x tile (eight threads per row, one 16-byte chunk each), and
// the weight rows [k0, k0 + 128) x columns [n0, n0 + BN) as they lie in
// memory ([128][BN], n contiguous). With kVec the copies are cp.async,
// zero-filled past M, K and ldw, and land later; otherwise byte loads and
// plain stores. Either way one commit group per call (empty when !any).
template <int WG, int BN, bool kVec>
__device__ __forceinline__ void stage_tile(int8_t* stage, const int8_t* x,
                                           const int8_t* w, int M, int K,
                                           int ldw, int m0, int n0, int k0,
                                           bool any, int tid) {
  using T = Tile<WG, BN>;
  if (any) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int i = tid + j * T::kThreads;
      const int r = i / 8, c = i % 8;
      const int m = m0 + r, k = k0 + c * 16;
      const int8_t* src = x + static_cast<long long>(m) * K + k;
      int8_t* dst = stage + swz(r, c);
      if (kVec) {
        const bool in = m < M && k < K;
        cp_async16(dst, in ? src : x, in);
      } else {
        uint32_t wd[4] = {0, 0, 0, 0};
        if (m < M) {
#pragma unroll
          for (int e = 0; e < 16; ++e)
            if (k + e < K)
              wd[e / 4] |=
                  static_cast<uint32_t>(static_cast<uint8_t>(src[e]))
                  << (8 * (e % 4));
        }
        *reinterpret_cast<uint4*>(dst) = make_uint4(wd[0], wd[1], wd[2],
                                                    wd[3]);
      }
    }
    int8_t* raw = stage + T::kStageA;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int i = tid + j * T::kThreads;
      const int r = i / (BN / 16), c = i % (BN / 16);
      const int k = k0 + r, n = n0 + 16 * c;
      const int8_t* src = w + static_cast<long long>(k) * ldw + n;
      int8_t* dst = raw + r * BN + 16 * c;
      if (kVec) {
        const bool in = k < K && n < ldw;
        cp_async16(dst, in ? src : w, in);
      } else {
        uint32_t wd[4] = {0, 0, 0, 0};
        if (k < K) {
#pragma unroll
          for (int e = 0; e < 16; ++e)
            if (n + e < ldw)
              wd[e / 4] |=
                  static_cast<uint32_t>(static_cast<uint8_t>(src[e]))
                  << (8 * (e % 4));
        }
        *reinterpret_cast<uint4*>(dst) = make_uint4(wd[0], wd[1], wd[2],
                                                    wd[3]);
      }
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// The stage's [128][BN] weights into the K-major swizzled [BN][128] tile:
// each thread reads a 16 (k) x 4 (n) block as 16 words (a warp reads whole
// rows) and writes it as four 16-byte K-major rows
template <int BN>
__device__ __forceinline__ void transpose_w(const int8_t* raw, int8_t* wt,
                                            int tid) {
  const int nq = tid % (BN / 4), kc = tid / (BN / 4);
  uint32_t b[16];
#pragma unroll
  for (int i = 0; i < 16; ++i)
    b[i] = *reinterpret_cast<const uint32_t*>(raw + (kc * 16 + i) * BN +
                                              4 * nq);
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    // column n = 4 nq + j, in an order that spreads a quarter warp's
    // 16-byte stores over all eight bank groups (n % 8 distinct)
    const int j = (s + (nq >> 1)) & 3;
    const uint32_t sel = static_cast<uint32_t>(j | ((j + 4) << 4));
    uint4 v;
    v.x = column_bytes(b[0], b[1], b[2], b[3], sel);
    v.y = column_bytes(b[4], b[5], b[6], b[7], sel);
    v.z = column_bytes(b[8], b[9], b[10], b[11], sel);
    v.w = column_bytes(b[12], b[13], b[14], b[15], sel);
    *reinterpret_cast<uint4*>(wt + swz(4 * nq + j, kc)) = v;
  }
}

// (f32(acc) * x_scale) * w_scale[n] (+ bias[n]): the epilogue's first
// step, rounded as the plain version rounds it
__device__ __forceinline__ float dequant(int acc, float xm,
                                         const float* __restrict__ ws,
                                         const float* __restrict__ bias,
                                         int n) {
  const float p = __fmul_rn(__int2float_rn(acc), xm);
  return bias ? __fmaf_rn(p, ws[n], bias[n]) : __fmul_rn(p, ws[n]);
}

template <int WG, int BN, bool kVec>
__global__ void __launch_bounds__(128 * WG, 4 / WG)
int8_matmul_tile_kernel(const int8_t* __restrict__ x,
                        const int8_t* __restrict__ w,
                        const float* __restrict__ xs,
                        const float* __restrict__ ws,
                        const float* __restrict__ bias,
                        void* __restrict__ out, int M, int K, int N, int ldw,
                        int mt, int nt, int act, int requant, float inv) {
  using T = Tile<WG, BN>;
  extern __shared__ __align__(128) int8_t smem_raw[];
  const int tid = threadIdx.x;
  const int wg = tid / 128;

  // grouped raster: kGroupM row tiles share each column tile in turn
  const int pid = blockIdx.x;
  const int per_group = kGroupM * nt;
  const int first_m = (pid / per_group) * kGroupM;
  const int group = min(mt - first_m, kGroupM);
  const int m0 = (first_m + (pid % per_group) % group) * T::kBM;
  const int n0 = ((pid % per_group) / group) * BN;

  int d[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) d[i] = 0;

  // the swizzle pattern follows address bits 7-9: align the stages
  const uint32_t raw =
      static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t base = (raw + 1023) & ~1023u;
  int8_t* smem = smem_raw + (base - raw);
  int8_t* wt = smem + kStages * T::kStage;
  const uint32_t a_wg = base + wg * 64 * 128;
  const uint32_t b_all = base + kStages * T::kStage;
  const int ntk = (K + kBK - 1) / kBK;

  // K tile t lands in stage t % kStages, copied kStages - 1 tiles ahead
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t)
    stage_tile<WG, BN, kVec>(smem + t * T::kStage, x, w, M, K, ldw, m0, n0,
                             t * kBK, t < ntk, tid);
  for (int t = 0; t < ntk; ++t) {
    const int st = t % kStages;
    // tile t landed (for every thread), and the previous wgmmas are done
    // with the transposed weights
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 2) : "memory");
    __syncthreads();
    transpose_w<BN>(smem + st * T::kStage + T::kStageA, wt, tid);
    // stage (t - 1) % kStages is free: x read by the last wgmmas, its
    // weights transposed last iteration
    stage_tile<WG, BN, kVec>(smem + ((t + kStages - 1) % kStages) * T::kStage,
                             x, w, M, K, ldw, m0, n0,
                             (t + kStages - 1) * kBK,
                             t + kStages - 1 < ntk, tid);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    const uint32_t a = a_wg + st * T::kStage;
    fence_operands(d);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int s = 0; s < kBK / 32; ++s)
      wgmma<BN>(d, smem_desc(a + 32 * s), smem_desc(b_all + 32 * s));
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_operands(d);
  }

  // The epilogue goes through shared memory, so global stores are whole
  // 16-byte pieces of output rows. Accumulator fragment: warp w of a
  // warpgroup holds rows 16w + lane/4 (+8), columns 8j + 2 (lane % 4) (+1)
  // for j = 0..BN/8-1.
  __syncthreads();  // every warpgroup is done with the stages
  const int lt = tid % 128, warp = lt / 32, lane = lt % 32;
  const int r0 = wg * 64 + warp * 16 + lane / 4;
  const int c0 = 2 * (lane % 4);
  if (requant) {
    constexpr int OS = BN + 16;  // int8 rows, 16-byte aligned
    int8_t* ot = smem;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + 8 * h, m = m0 + r;
      const float xm = m < M ? xs[m] : 0.0f;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = c0 + 8 * j + e, n = n0 + c;
          int8_t q = 0;
          if (m < M && n < N)
            q = requantize(
                apply_act(dequant(d[4 * j + 2 * h + e], xm, ws, bias, n),
                          act),
                inv);
          ot[r * OS + c] = q;
        }
    }
    __syncthreads();
    int8_t* o = static_cast<int8_t*>(out);
    for (int i = tid; i < T::kBM * (BN / 16); i += T::kThreads) {
      const int r = i / (BN / 16), c = 16 * (i % (BN / 16));
      const int m = m0 + r, n = n0 + c;
      if (m >= M || n >= N) continue;
      const long long idx = static_cast<long long>(m) * N + n;
      if (N % 16 == 0) {
        *reinterpret_cast<uint4*>(o + idx) =
            *reinterpret_cast<const uint4*>(ot + r * OS + c);
      } else {
        for (int e = 0; e < 16 && n + e < N; ++e)
          o[idx + e] = ot[r * OS + c + e];
      }
    }
  } else {
    constexpr int OS = BN + 8;  // fp32 rows; float2 writes free of conflicts
    float* ot = reinterpret_cast<float*>(smem);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + 8 * h, m = m0 + r;
      const float xm = m < M ? xs[m] : 0.0f;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        float v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = n0 + c0 + 8 * j + e;
          v[e] = (m < M && n < N)
                     ? apply_act(dequant(d[4 * j + 2 * h + e], xm, ws, bias,
                                         n),
                                 act)
                     : 0.0f;
        }
        *reinterpret_cast<float2*>(ot + r * OS + c0 + 8 * j) =
            make_float2(v[0], v[1]);
      }
    }
    __syncthreads();
    float* o = static_cast<float*>(out);
    for (int i = tid; i < T::kBM * (BN / 4); i += T::kThreads) {
      const int r = i / (BN / 4), c = 4 * (i % (BN / 4));
      const int m = m0 + r, n = n0 + c;
      if (m >= M || n >= N) continue;
      const long long idx = static_cast<long long>(m) * N + n;
      if (N % 4 == 0) {
        *reinterpret_cast<float4*>(o + idx) =
            *reinterpret_cast<const float4*>(ot + r * OS + c);
      } else {
        for (int e = 0; e < 4 && n + e < N; ++e)
          o[idx + e] = ot[r * OS + c + e];
      }
    }
  }
}

template <int WG, int BN, bool kVec>
int launch(const void* x, const void* w, const void* xs, const void* ws,
           const void* bias, void* out, int M, int K, int N, int ldw, int act,
           int requant, float inv, cudaStream_t stream) {
  using T = Tile<WG, BN>;
  const long long mt = (M + T::kBM - 1) / T::kBM, nt = (N + BN - 1) / BN;
  if (mt * nt > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      int8_matmul_tile_kernel<WG, BN, kVec>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int8_matmul_tile_kernel<WG, BN, kVec>
      <<<mt * nt, T::kThreads, T::kSmem, stream>>>(
          static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
          static_cast<const float*>(xs), static_cast<const float*>(ws),
          static_cast<const float*>(bias), out, M, K, N, ldw, mt, nt, act,
          requant, inv);
  return static_cast<int>(cudaGetLastError());
}

template <int WG, int BN>
int launch_tile(bool vec, const void* x, const void* w, const void* xs,
                const void* ws, const void* bias, void* out, int M, int K,
                int N, int ldw, int act, int requant, float inv,
                cudaStream_t s) {
  return vec ? launch<WG, BN, true>(x, w, xs, ws, bias, out, M, K, N, ldw,
                                    act, requant, inv, s)
             : launch<WG, BN, false>(x, w, xs, ws, bias, out, M, K, N, ldw,
                                     act, requant, inv, s);
}

}  // namespace

// Same interface as int8_matmul (csrc/int8_matmul.cu) without the scratch:
// x [M, K] row-major, w [K, *] with row stride ldw (>= N), xs [M], ws and
// bias with at least N entries, out [M, N]. 16-byte cp.async copies of x
// and w where K % 16 == 0, ldw % 16 == 0 and both bases are 16-byte
// aligned; byte loads otherwise. N <= 64 takes the 64 x 64 tile.
extern "C" int int8_matmul_tile(const void* x, const void* w, const void* xs,
                                const void* ws, const void* bias, void* out,
                                int M, int K, int N, int ldw, int act,
                                int requant, float inv, void* stream) {
  if (M == 0 || N == 0) return 0;
  if (ldw < N) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = K % 16 == 0 && ldw % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(w) % 16 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N <= 64)
    return launch_tile<1, 64>(vec, x, w, xs, ws, bias, out, M, K, N, ldw,
                              act, requant, inv, s);
  return launch_tile<2, 128>(vec, x, w, xs, ws, bias, out, M, K, N, ldw, act,
                             requant, inv, s);
}
