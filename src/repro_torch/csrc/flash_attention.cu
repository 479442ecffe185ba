// flash_attention: causal or non-causal GQA attention over [B, S, H, hd]
// fp32 tensors, with an online (running max / running sum) softmax.
//
// Replaces the Pallas kernel `flash_attention` (src/repro/kernels/
// flash_attention.py, `_kernel`). What bounds it on an H100: at the served
// shape (B = 4, S = 2048, 32 heads, hd = 64, causal) the two products take
// 68.7 GFLOP against 268 MB of q/k/v/o, so arithmetic bounds it, not memory
// (0.08 ms). In plain fp32 that is 1.03 ms at the 67 TFLOP/s outside the
// tensor cores. The tensor cores take TF32: they read the top 19 bits of
// each 32-bit operand (10 mantissa bits), which alone breaks the fp32
// tolerance this port holds the kernel to (2e-5). So each product is a
// 3xTF32 split, x = big + small, and
//   a * b ~= small_a * big_b + big_a * small_b + big_a * big_b
// (small * small, ~2^-20 relative, is dropped). big is x with its low 13
// bits cleared, small = x - big (exact in fp32), and the tensor cores
// read small's top 19 bits: two instructions per operand, where
// cvt.rna.tf32 takes several; the error stays ~2^-20 of each product (tests/test_torch_tf32x3.py
// emulates both splits). Three TF32 products at 495 TFLOP/s bound the
// split at 0.42 ms for the served shape.
//
// Design (what it does about the bound and the TPU-to-GPU differences):
//   * one block of 8 warps per (128-row query tile, query head, batch), in
//     FlashAttention-2's arrangement: each warp owns 16 query rows. The TPU
//     kernel walked the K/V blocks on a sequential 'arbitrary' grid axis
//     and carried m, l and the accumulator in VMEM between grid steps;
//     here that axis is a loop inside the block over 64-row K/V tiles
//     staged in shared memory, and m, l and the accumulator live in
//     registers for the whole loop;
//   * both products are `mma.sync.m16n8k8` TF32 with fp32 accumulation,
//     three per 16 x 8 x 8 step: for each step, the small terms of all
//     eight column groups first, then the big ones, so no mma waits on the
//     one before it;
//   * the contraction index of each 8-deep step is permuted: fragment
//     column t stands for index 2t and column t + 4 for 2t + 1, in A and
//     B alike, which leaves each dot product unchanged. Then a thread's
//     Q and K fragments are two adjacent floats of a row (one 8-byte
//     load each), and the scores that S = Q K^T leaves in the C layout
//     (row lane/4 and +8, keys 2 (lane % 4) and +1 of each 8-key group)
//     are already the A fragment of P for O += P V: P never leaves
//     registers. V is [key][d] with d contiguous, the B fragment's layout
//     as it stands: no transpose;
//   * operands are split into big and small as their fragments are
//     loaded; Q, K and V stay fp32 in shared memory, rows padded (Q and K
//     by 8 floats, V by 4) so that every fragment load is free of bank
//     conflicts;
//   * K/V tiles are double-buffered and fetched with cp.async (16 bytes
//     per copy, zero-filled past Sk and hd): the next tile's copies are in
//     flight while this tile is computed, so global latency is hidden
//     without holding registers;
//   * each row's max and sum reduce inside a quad (__shfl_xor_sync 1, 2);
//   * the K/V head is h / (Hq / Hkv), as the reference's index maps pick
//     it: grouped query heads read the same K/V rows, nothing is repeated
//     in memory;
//   * q/k/v are read in place through their strides (16-byte copies where
//     hd, the strides and the bases allow, else 4-byte loads); rows past
//     Sq/Sk and columns past hd are staged as zeros and the scores of keys
//     past Sk are masked to -2e38 in-kernel;
//   * causal: tiles wholly above the diagonal are never loaded, a warp
//     skips the products of a tile wholly above its own rows, and the tile
//     that crosses the diagonal masks qpos < kpos (top-left aligned
//     positions, as the reference). Later query tiles have more work, so
//     they are launched first;
//   * the scale is applied after the dot (__fmul_rn), exp is expf and the
//     final division is IEEE (no fast math): the output is
//     acc / max(l, 1e-30), as the reference finalises it.
#include "common.cuh"

namespace {

constexpr int kBQ = 128;       // query rows per block
constexpr int kBK = 64;        // key rows per tile
constexpr int kWarps = 8;      // 16 query rows each
constexpr int kThreads = 32 * kWarps;
constexpr float kNegInf = -2.0e38f;

template <int HD>  // head dim padded up to 64 or 128
struct Smem {
  static constexpr int kQStride = HD + 8;   // Qs[kBQ][HD + 8]
  static constexpr int kKStride = HD + 8;   // Ks[2][kBK][HD + 8]
  static constexpr int kVStride = HD + 4;   // Vs[2][kBK][HD + 4]
  static constexpr int kQ = kBQ * kQStride;
  static constexpr int kK = kBK * kKStride;
  static constexpr int kV = kBK * kVStride;
  static constexpr int kBytes = (kQ + 2 * kK + 2 * kV) * 4;
};

// 16 bytes from global to shared memory, zero-filled when !in
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool in) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(in ? 16 : 0)
               : "memory");
}

// rows [r0, r0 + rows) of a [*, hd] operand (row stride ld) into a padded
// shared tile, zeros past `limit` rows and past hd: cp.async where `vec`
// (hd, strides and bases in whole float4s), else plain loads and stores
template <int HD, int STRIDE>
__device__ __forceinline__ void stage_rows(float* dst, const float* src,
                                           long long ld, int r0, int rows,
                                           int limit, int hd, bool vec,
                                           int tid) {
  for (int i = tid; i < rows * HD / 4; i += kThreads) {
    const int r = i / (HD / 4), d = 4 * (i % (HD / 4)), p = r0 + r;
    float* to = dst + r * STRIDE + d;
    if (vec) {
      const bool in = p < limit && d < hd;
      cp_async16(to, in ? src + p * ld + d : src, in);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        to[e] = (p < limit && d + e < hd) ? src[p * ld + d + e] : 0.0f;
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int HD>  // two blocks per SM at hd 64, one at 128 (shared memory)
__global__ void __launch_bounds__(kThreads, HD == 64 ? 2 : 1)
flash_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ o,
                       int Sq, int Sk, int Hq, int hd, int group,
                       long long qsb, long long qss, long long qsh,
                       long long ksb, long long kss, long long ksh,
                       long long vsb, long long vss, long long vsh,
                       float scale, int causal, int vec) {
  using S = Smem<HD>;
  constexpr int ND = HD / 8;  // 8-wide column groups of the accumulator
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* Ks = Qs + S::kQ;          // two buffers
  float* Vs = Ks + 2 * S::kK;      // two buffers

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;  // heavier tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const float* qb = q + b * qsb + h * qsh;
  const float* kb = k + b * ksb + (h / group) * ksh;
  const float* vb = v + b * vsb + (h / group) * vsh;

  // causal: keys past this tile's last query row are masked for all rows
  const int k_end = causal ? min(Sk, q0 + kBQ) : Sk;
  const int n_tiles = (k_end + kBK - 1) / kBK;
  stage_rows<HD, S::kQStride>(Qs, qb, qss, q0, kBQ, Sq, hd, vec, tid);
  stage_rows<HD, S::kKStride>(Ks, kb, kss, 0, kBK, Sk, hd, vec, tid);
  stage_rows<HD, S::kVStride>(Vs, vb, vss, 0, kBK, Sk, hd, vec, tid);

  // rows qp[0] = q0 + 16 warp + g and qp[1] = qp[0] + 8 of this thread
  const int qp[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  const float* qw = Qs + (warp * 16 + g) * S::kQStride + 2 * t;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};
  float acc[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int k0 = tile * kBK;
    const int buf = tile & 1;
    if (tile + 1 < n_tiles) {  // the next tile's copies, in flight
      stage_rows<HD, S::kKStride>(Ks + (buf ^ 1) * S::kK, kb, kss,
                                  k0 + kBK, kBK, Sk, hd, vec, tid);
      stage_rows<HD, S::kVStride>(Vs + (buf ^ 1) * S::kV, vb, vss,
                                  k0 + kBK, kBK, Sk, hd, vec, tid);
      asm volatile("cp.async.wait_group 2;\n" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    }
    __syncthreads();  // this tile (and Q) landed for every thread
    // a tile wholly above this warp's rows adds nothing
    if (!causal || k0 <= q0 + warp * 16 + 15) {
      const float* kt = Ks + buf * S::kK;
      const float* vt = Vs + buf * S::kV;

      // S = Q K^T for this warp's 16 rows and the tile's 64 keys
      float s[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.0f;
#pragma unroll 2
      for (int kk = 0; kk < HD; kk += 8) {
        const float2 x0 = *reinterpret_cast<const float2*>(qw + kk);
        const float2 x1 = *reinterpret_cast<const float2*>(
            qw + 8 * S::kQStride + kk);
        uint32_t ab[4], as[4];
        split_tf32(x0.x, ab[0], as[0]);
        split_tf32(x1.x, ab[1], as[1]);
        split_tf32(x0.y, ab[2], as[2]);
        split_tf32(x1.y, ab[3], as[3]);
        float bx[8], by[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float2 w = *reinterpret_cast<const float2*>(
              kt + (8 * j + g) * S::kKStride + kk + 2 * t);
          bx[j] = w.x;
          by[j] = w.y;
        }
        mma8_3xtf32(s, 0, ab, as, bx, by);
      }

      // scale, mask, online softmax; element e of s[j] is row qp[e / 2],
      // key k0 + 8 j + 2 t + e % 2
      const bool mask = (causal && k0 + kBK - 1 > q0) || k0 + kBK > Sk;
      float rmax[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kp = k0 + 8 * j + 2 * t + (e & 1);
          float x = __fmul_rn(s[j][e], scale);
          if (mask && (kp >= Sk || (causal && kp > qp[e / 2]))) x = kNegInf;
          s[j][e] = x;
          rmax[e / 2] = fmaxf(rmax[e / 2], x);
        }
      float alpha[2], rsum[2] = {0.0f, 0.0f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        rmax[r] = fmaxf(rmax[r], __shfl_xor_sync(0xffffffffu, rmax[r], 1));
        rmax[r] = fmaxf(rmax[r], __shfl_xor_sync(0xffffffffu, rmax[r], 2));
        const float m_new = fmaxf(m[r], rmax[r]);
        alpha[r] = expf(m[r] - m_new);
        m[r] = m_new;
      }
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[j][e] = expf(s[j][e] - m[e / 2]);
          rsum[e / 2] += s[j][e];
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        rsum[r] += __shfl_xor_sync(0xffffffffu, rsum[r], 1);
        rsum[r] += __shfl_xor_sync(0xffffffffu, rsum[r], 2);
        l[r] = __fadd_rn(__fmul_rn(l[r], alpha[r]), rsum[r]);
      }
#pragma unroll
      for (int j = 0; j < ND; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[j][e] = __fmul_rn(acc[j][e], alpha[e / 2]);

      // O += P V: s[j] is P's A fragment for keys 8j..8j+7 as it stands
      // (columns t, t + 4 stand for keys 2t, 2t + 1)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        uint32_t ab[4], as[4];
        split_tf32(s[j][0], ab[0], as[0]);
        split_tf32(s[j][2], ab[1], as[1]);
        split_tf32(s[j][1], ab[2], as[2]);
        split_tf32(s[j][3], ab[3], as[3]);
        const float* v0 = vt + (8 * j + 2 * t) * S::kVStride + g;
#pragma unroll
        for (int c = 0; c < ND / 8; ++c) {
          float bx[8], by[8];
#pragma unroll
          for (int jd = 0; jd < 8; ++jd) {
            bx[jd] = v0[8 * (8 * c + jd)];
            by[jd] = v0[S::kVStride + 8 * (8 * c + jd)];
          }
          mma8_3xtf32(acc, 8 * c, ab, as, bx, by);
        }
      }
    }
    __syncthreads();  // every warp is done with this buffer
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (qp[r] >= Sq) continue;
    const float denom = fmaxf(l[r], 1e-30f);
    float* orow =
        o + ((static_cast<long long>(b) * Sq + qp[r]) * Hq + h) * hd;
#pragma unroll
    for (int j = 0; j < ND; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int d = 8 * j + 2 * t + e;
        if (d < hd) orow[d] = __fdiv_rn(acc[j][2 * r + e], denom);
      }
  }
}

template <int HD>
int launch(const float* q, const float* k, const float* v, float* o, int B,
           int Sq, int Sk, int Hq, int hd, int group, const long long* st,
           float scale, int causal, cudaStream_t stream) {
  // 16-byte copies need hd, every row stride and every base in whole
  // float4s
  bool vec = hd % 4 == 0 && reinterpret_cast<uintptr_t>(q) % 16 == 0 &&
             reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
             reinterpret_cast<uintptr_t>(v) % 16 == 0;
  for (int i = 0; i < 9; ++i) vec = vec && st[i] % 4 == 0;
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Smem<HD>::kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((Sq + kBQ - 1) / kBQ, Hq, B);
  flash_attention_kernel<HD><<<grid, kThreads, Smem<HD>::kBytes, stream>>>(
      q, k, v, o, Sq, Sk, Hq, hd, group, st[0], st[1], st[2], st[3], st[4],
      st[5], st[6], st[7], st[8], scale, causal, vec ? 1 : 0);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q [B, Sq, Hq, hd], k/v [B, Sk, Hkv, hd] fp32 with unit stride on hd;
// strides = {q: batch, seq, head; k: ...; v: ...} in elements. o is a
// contiguous [B, Sq, Hq, hd] fp32 output. hd <= 128.
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* o, int B, int Sq, int Sk, int Hq,
                               int Hkv, int hd, const long long* strides,
                               float scale, int causal, void* stream) {
  if (B == 0 || Sq == 0 || Hq == 0) return 0;
  if (hd < 1 || hd > 128 || Sk < 1 || Hkv < 1 || Hq % Hkv != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  float* of = static_cast<float*>(o);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hd <= 64)
    return launch<64>(qf, kf, vf, of, B, Sq, Sk, Hq, hd, Hq / Hkv, strides,
                      scale, causal, s);
  return launch<128>(qf, kf, vf, of, B, Sq, Sk, Hq, hd, Hq / Hkv, strides,
                     scale, causal, s);
}
