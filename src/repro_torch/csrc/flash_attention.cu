// flash_attention: causal or non-causal GQA attention over [B, S, H, hd]
// fp32 tensors, with an online (running max / running sum) softmax.
//
// Replaces the Pallas kernel `flash_attention` (src/repro/kernels/
// flash_attention.py, `_kernel`). What bounds it on an H100: at the served
// shape (B = 4, S = 2048, 32 heads, hd = 64, causal) the two products take
// 68.7 GFLOP against 268 MB of q/k/v/o, so the fp32 rate bounds it
// (67 TFLOP/s outside the tensor cores: 1.03 ms), not memory (0.08 ms).
// The tensor cores would be the way past that, but TF32 rounds the
// operands to 10 mantissa bits and breaks the fp32 tolerance this port
// holds the kernel to; `wgmma` with a 3xTF32 split is later work.
//
// Design (what it does about the bound and the TPU-to-GPU differences):
//   * one block of 256 threads per (64-row query tile, query head, batch).
//     The TPU kernel walked the K/V blocks on a sequential 'arbitrary'
//     grid axis and carried m, l and the accumulator in VMEM between grid
//     steps; here that axis is a loop inside the block over 64-row K/V
//     tiles staged in shared memory, and m, l and the accumulator live in
//     registers for the whole loop;
//   * the K/V head is h / (Hq / Hkv), as the reference's index maps pick
//     it: grouped query heads read the same K/V rows, nothing is repeated
//     in memory;
//   * q/k/v are read in place through their strides (no padded copies,
//     no transposes); rows past Sq/Sk and columns past hd are staged as
//     zeros and the scores of keys past Sk are masked to -2e38 in-kernel;
//   * causal: tiles wholly above the diagonal are never loaded; the tile
//     that crosses it masks qpos < kpos (top-left aligned positions, as
//     the reference). Later query tiles have more work, so they are
//     launched first;
//   * every thread holds a 4x4 patch of the 64x64 score tile and a
//     4 x (HD/16) patch of the accumulator; the 16 threads of a row group
//     (one half-warp) reduce the row max and sum with warp shuffles. The
//     inner loops read shared memory as float4 (8 wide loads per 64
//     fused multiply-adds), K is staged transposed, and rows are padded
//     by 4 floats so the two half-warps of a warp hit different banks;
//   * exp is expf and the final division is IEEE (no fast math): the
//     output is acc / max(l, 1e-30), as the reference finalises it.
#include "common.cuh"

namespace {

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // key rows per tile
constexpr int kThreads = 256;  // 16 x 16 threads
constexpr int kPad = 4;        // row padding in floats
constexpr float kNegInf = -2.0e38f;

template <int HD>  // head dim padded up to 64 or 128
struct Smem {
  static constexpr int kQStride = HD + kPad;   // Qs[kBQ][HD + pad]
  static constexpr int kKStride = kBK + kPad;  // Kt[HD][kBK + pad]
  static constexpr int kPStride = kBK + kPad;  // Ps[kBQ][kBK + pad]
  static constexpr int kQ = kBQ * kQStride;
  static constexpr int kK = HD * kKStride;
  static constexpr int kV = kBK * HD;          // Vs[kBK][HD]
  static constexpr int kP = kBQ * kPStride;
  static constexpr int kBytes = (kQ + kK + kV + kP) * 4;
};

__device__ __forceinline__ float comp(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ o,
                       int Sq, int Sk, int Hq, int hd, int group,
                       long long qsb, long long qss, long long qsh,
                       long long ksb, long long kss, long long ksh,
                       long long vsb, long long vss, long long vsh,
                       float scale, int causal) {
  using S = Smem<HD>;
  constexpr int CPT = HD / 16;  // accumulator columns per thread
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* Kt = Qs + S::kQ;
  float* Vs = Kt + S::kK;
  float* Ps = Vs + S::kV;

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;  // heavier tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const float* qb = q + b * qsb + h * qsh;
  const float* kb = k + b * ksb + (h / group) * ksh;
  const float* vb = v + b * vsb + (h / group) * vsh;

  for (int i = tid; i < kBQ * HD; i += kThreads) {
    const int r = i / HD, d = i % HD, qp = q0 + r;
    Qs[r * S::kQStride + d] =
        (qp < Sq && d < hd) ? qb[qp * qss + d] : 0.0f;
  }

  float m[4], l[4], acc[4][CPT];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = kNegInf;
    l[r] = 0.0f;
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[r][c] = 0.0f;
  }

  // causal: keys past this tile's last query row are masked for all rows
  const int k_end = causal ? min(Sk, q0 + kBQ) : Sk;
  const int n_tiles = (k_end + kBK - 1) / kBK;
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBK;
    __syncthreads();  // Qs staged / the previous tile's Kt, Vs, Ps read
    for (int i = tid; i < kBK * HD; i += kThreads) {
      const int r = i / HD, d = i % HD, kp = k0 + r;
      const bool in = kp < Sk && d < hd;
      Kt[d * S::kKStride + r] = in ? kb[kp * kss + d] : 0.0f;
      Vs[r * HD + d] = in ? vb[kp * vss + d] : 0.0f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[r][c] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      float4 qv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
        qv[r] = *reinterpret_cast<const float4*>(
            &Qs[(ty * 4 + r) * S::kQStride + d]);
#pragma unroll
      for (int dd = 0; dd < 4; ++dd) {
        const float4 kv = *reinterpret_cast<const float4*>(
            &Kt[(d + dd) * S::kKStride + tx * 4]);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float a = comp(qv[r], dd);
          s[r][0] = fmaf(a, kv.x, s[r][0]);
          s[r][1] = fmaf(a, kv.y, s[r][1]);
          s[r][2] = fmaf(a, kv.z, s[r][2]);
          s[r][3] = fmaf(a, kv.w, s[r][3]);
        }
      }
    }

    const bool mask = (causal && k0 + kBK - 1 > q0) || k0 + kBK > Sk;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int qp = q0 + ty * 4 + r;
      float rmax = kNegInf;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int kp = k0 + tx * 4 + c;
        float x = __fmul_rn(s[r][c], scale);
        if (mask && (kp >= Sk || (causal && kp > qp))) x = kNegInf;
        s[r][c] = x;
        rmax = fmaxf(rmax, x);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, off));
      const float m_new = fmaxf(m[r], rmax);
      const float alpha = expf(m[r] - m_new);
      float rsum = 0.0f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[r][c] = expf(s[r][c] - m_new);
        rsum += s[r][c];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rsum += __shfl_xor_sync(0xffffffffu, rsum, off);
      l[r] = __fadd_rn(__fmul_rn(l[r], alpha), rsum);
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[r][c] = __fmul_rn(acc[r][c], alpha);
      *reinterpret_cast<float4*>(&Ps[(ty * 4 + r) * S::kPStride + tx * 4]) =
          make_float4(s[r][0], s[r][1], s[r][2], s[r][3]);
    }
    __syncthreads();

#pragma unroll 2
    for (int j = 0; j < kBK; j += 4) {
      float4 pv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
        pv[r] = *reinterpret_cast<const float4*>(
            &Ps[(ty * 4 + r) * S::kPStride + j]);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        float vv[CPT];
#pragma unroll
        for (int c = 0; c < CPT; c += 4) {
          const float4 w = *reinterpret_cast<const float4*>(
              &Vs[(j + jj) * HD + tx * CPT + c]);
          vv[c] = w.x;
          vv[c + 1] = w.y;
          vv[c + 2] = w.z;
          vv[c + 3] = w.w;
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float p = comp(pv[r], jj);
#pragma unroll
          for (int c = 0; c < CPT; ++c) acc[r][c] = fmaf(p, vv[c], acc[r][c]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int qp = q0 + ty * 4 + r;
    if (qp >= Sq) continue;
    const float denom = fmaxf(l[r], 1e-30f);
    float* orow = o + ((static_cast<long long>(b) * Sq + qp) * Hq + h) * hd;
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int d = tx * CPT + c;
      if (d < hd) orow[d] = __fdiv_rn(acc[r][c], denom);
    }
  }
}

template <int HD>
int launch(const float* q, const float* k, const float* v, float* o, int B,
           int Sq, int Sk, int Hq, int hd, int group, const long long* st,
           float scale, int causal, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Smem<HD>::kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((Sq + kBQ - 1) / kBQ, Hq, B);
  flash_attention_kernel<HD><<<grid, kThreads, Smem<HD>::kBytes, stream>>>(
      q, k, v, o, Sq, Sk, Hq, hd, group, st[0], st[1], st[2], st[3], st[4],
      st[5], st[6], st[7], st[8], scale, causal);
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
