// ssd: the Mamba-2 state-space-duality chunked scan, fp32.
//
// Replaces the Pallas kernel `ssd` (src/repro/kernels/ssd.py, `_kernel`).
// Per (batch, head) and per chunk of Q positions, with the [P, N] state
// carried from chunk to chunk:
//     a = dt * A[h]                  cum = cumsum(a)
//     L = tril(exp(cum_i - cum_j))                 [Q, Q]
//     M = (C @ B^T) * L * dt_j                     [Q, Q]
//     y = M @ x  +  exp(cum)_i * (C @ state^T)     [Q, P]
//     state = exp(cum_Q) * state + ((suffix * dt) . x)^T B
// What bounds it on an H100: at the served shape (B = 4, S = 2048, H = 64,
// P = N = 64, Q = 256) the chunk products on and below each chunk's
// diagonal (L is lower-triangular) take 25.8 GFLOP against 279 MB of
// x/y/B/C/dt/state, so the fp32 rate bounds it (0.39 ms at 67 TFLOP/s),
// not memory (0.08 ms).
// No tensor cores: TF32 would break the fp32 tolerance.
//
// Design:
//   * one block of 256 threads per (head, batch). The TPU kernel walked
//     the chunks on a sequential 'arbitrary' grid axis and kept the state
//     in VMEM between steps; here the chunk loop runs inside the block and
//     the state stays in shared memory (stored transposed, [N][P]) for the
//     whole scan. B x H = 256 blocks at the served shape: about two per SM;
//   * a full [Q, Q] fp32 M at Q = 256 is 256 KB, over the 227 KB a block
//     may have, so the chunk is cut into 64-row strips and M is formed one
//     64 x 64 tile at a time: for strip i and column tile j <= i, G = C_i
//     B_j^T, M = (G * L) * dt_j, y_i += M x_j. Tiles above the diagonal
//     are all zero in L and are skipped;
//   * cum is an inclusive prefix sum taken left to right by one thread
//     (Q adds per chunk); dt, cum and exp(cum) sit in shared memory;
//   * the state update runs after every strip has read the old state;
//   * the tiles use the same 4 x 4 per-thread patches, float4 shared
//     loads and padded rows as csrc/flash_attention.cu;
//   * a chunk that is not a multiple of 64 (the divisor fallback the
//     wrapper repeats) stages zeros past Q and masks those rows/columns.
// exp is expf (no fast math); each multiply and add of the reference's
// elementwise formulas rounds on its own (-fmad=false).
#include "common.cuh"

namespace {

constexpr int kT = 64;         // strip rows / tile columns
constexpr int kPP = 64;        // P padded (P <= 64)
constexpr int kThreads = 256;  // 16 x 16 threads
constexpr int kPad = 4;

template <int NP>  // N padded up to 64 or 128
struct Smem {
  static constexpr int kCStride = NP + kPad;   // Cs[kT][NP + pad]
  static constexpr int kBtStride = kT + kPad;  // Bt[NP][kT + pad] (G phase)
  static constexpr int kBrStride = NP + kPad;  // Br[kT][NP + pad] (state)
  static constexpr int kMStride = kT + kPad;   // Ms[kT][kT + pad]
  static constexpr int kSStride = kPP + kPad;  // St[NP][kPP + pad]
  static constexpr int kC = kT * kCStride;
  static constexpr int kB = (NP * kBtStride > kT * kBrStride)
                                ? NP * kBtStride : kT * kBrStride;
  static constexpr int kX = kT * kPP;          // Xs[kT][kPP]
  static constexpr int kM = kT * kMStride;
  static constexpr int kS = NP * kSStride;
  static constexpr int kFixed = kC + kB + kX + kM + kS;
  static int bytes(int Q) { return (kFixed + 3 * Q) * 4; }
};

__device__ __forceinline__ float comp(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

template <int NP>
__global__ void __launch_bounds__(kThreads)
ssd_kernel(const float* __restrict__ x, const float* __restrict__ Bm,
           const float* __restrict__ Cm, const float* __restrict__ dt,
           const float* __restrict__ A, const float* __restrict__ init,
           float* __restrict__ y, float* __restrict__ final_state,
           int S, int H, int P, int N, int Q) {
  using Sm = Smem<NP>;
  constexpr int NPT = NP / 16;  // state columns per thread (update phase)
  extern __shared__ __align__(16) float smem[];
  float* Cs = smem;
  float* Bs = Cs + Sm::kC;
  float* Xs = Bs + Sm::kB;
  float* Ms = Xs + Sm::kX;
  float* St = Ms + Sm::kM;
  float* dts = St + Sm::kS;
  float* cum = dts + Q;
  float* ecum = cum + Q;

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int h = blockIdx.x, b = blockIdx.y;
  const float a_h = A[h];
  const long long bs = static_cast<long long>(b) * S;
  const long long xrow = static_cast<long long>(H) * P;  // x row stride
  const long long sbase = (static_cast<long long>(b) * H + h) * P * N;

  for (int i = tid; i < NP * kPP; i += kThreads) {
    const int n = i / kPP, p = i % kPP;
    St[n * Sm::kSStride + p] =
        (init != nullptr && p < P && n < N) ? init[sbase + p * N + n] : 0.0f;
  }

  const int n_strips = (Q + kT - 1) / kT;
  for (int c0 = 0; c0 < S; c0 += Q) {
    __syncthreads();  // the previous chunk's reads of dts/cum/ecum are done
    for (int i = tid; i < Q; i += kThreads)
      dts[i] = dt[(bs + c0 + i) * H + h];
    __syncthreads();
    if (tid == 0) {
      float run = 0.0f;
      for (int i = 0; i < Q; ++i) {
        run = __fadd_rn(run, __fmul_rn(dts[i], a_h));
        cum[i] = run;
      }
    }
    __syncthreads();
    for (int i = tid; i < Q; i += kThreads) ecum[i] = expf(cum[i]);

    // ---- y, one 64-row strip at a time --------------------------------
    for (int si = 0; si < n_strips; ++si) {
      const int i0 = si * kT;
      float yacc[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) yacc[r][c] = 0.0f;

      for (int tj = 0; tj <= si; ++tj) {
        const int j0 = tj * kT;
        __syncthreads();  // Bs/Xs/Ms of the previous tile are read
        if (tj == 0) {
          for (int e = tid; e < kT * NP; e += kThreads) {
            const int r = e / NP, n = e % NP, i = i0 + r;
            Cs[r * Sm::kCStride + n] =
                (i < Q && n < N) ? Cm[(bs + c0 + i) * N + n] : 0.0f;
          }
        }
        for (int e = tid; e < kT * NP; e += kThreads) {
          const int r = e / NP, n = e % NP, j = j0 + r;
          Bs[n * Sm::kBtStride + r] =
              (j < Q && n < N) ? Bm[(bs + c0 + j) * N + n] : 0.0f;
        }
        for (int e = tid; e < kT * kPP; e += kThreads) {
          const int r = e / kPP, p = e % kPP, j = j0 + r;
          Xs[r * kPP + p] =
              (j < Q && p < P) ? x[(bs + c0 + j) * xrow + h * P + p] : 0.0f;
        }
        __syncthreads();

        // G = C_i B_j^T (4 x 4 per thread), then M = (G * L) * dt_j
        float g[4][4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) g[r][c] = 0.0f;
#pragma unroll 4
        for (int n = 0; n < NP; n += 4) {
          float4 cv[4];
#pragma unroll
          for (int r = 0; r < 4; ++r)
            cv[r] = *reinterpret_cast<const float4*>(
                &Cs[(ty * 4 + r) * Sm::kCStride + n]);
#pragma unroll
          for (int nn = 0; nn < 4; ++nn) {
            const float4 bv = *reinterpret_cast<const float4*>(
                &Bs[(n + nn) * Sm::kBtStride + tx * 4]);
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              const float cc = comp(cv[r], nn);
              g[r][0] = fmaf(cc, bv.x, g[r][0]);
              g[r][1] = fmaf(cc, bv.y, g[r][1]);
              g[r][2] = fmaf(cc, bv.z, g[r][2]);
              g[r][3] = fmaf(cc, bv.w, g[r][3]);
            }
          }
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = i0 + ty * 4 + r;
          float mrow[4];
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int j = j0 + tx * 4 + c;
            float mv = 0.0f;
            if (i < Q && j < Q && j <= i) {
              const float L = expf(__fsub_rn(cum[i], cum[j]));
              mv = __fmul_rn(__fmul_rn(g[r][c], L), dts[j]);
            }
            mrow[c] = mv;
          }
          *reinterpret_cast<float4*>(
              &Ms[(ty * 4 + r) * Sm::kMStride + tx * 4]) =
              make_float4(mrow[0], mrow[1], mrow[2], mrow[3]);
        }
        __syncthreads();

        // y_i += M x_j
#pragma unroll 2
        for (int j = 0; j < kT; j += 4) {
          float4 mv[4];
#pragma unroll
          for (int r = 0; r < 4; ++r)
            mv[r] = *reinterpret_cast<const float4*>(
                &Ms[(ty * 4 + r) * Sm::kMStride + j]);
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            const float4 xv = *reinterpret_cast<const float4*>(
                &Xs[(j + jj) * kPP + tx * 4]);
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              const float mm = comp(mv[r], jj);
              yacc[r][0] = fmaf(mm, xv.x, yacc[r][0]);
              yacc[r][1] = fmaf(mm, xv.y, yacc[r][1]);
              yacc[r][2] = fmaf(mm, xv.z, yacc[r][2]);
              yacc[r][3] = fmaf(mm, xv.w, yacc[r][3]);
            }
          }
        }
      }

      // y_i += exp(cum_i) * (C_i state^T), with the state entering the chunk
      float yin[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) yin[r][c] = 0.0f;
#pragma unroll 4
      for (int n = 0; n < NP; n += 4) {
        float4 cv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
          cv[r] = *reinterpret_cast<const float4*>(
              &Cs[(ty * 4 + r) * Sm::kCStride + n]);
#pragma unroll
        for (int nn = 0; nn < 4; ++nn) {
          const float4 sv = *reinterpret_cast<const float4*>(
              &St[(n + nn) * Sm::kSStride + tx * 4]);
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const float cc = comp(cv[r], nn);
            yin[r][0] = fmaf(cc, sv.x, yin[r][0]);
            yin[r][1] = fmaf(cc, sv.y, yin[r][1]);
            yin[r][2] = fmaf(cc, sv.z, yin[r][2]);
            yin[r][3] = fmaf(cc, sv.w, yin[r][3]);
          }
        }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = i0 + ty * 4 + r;
        if (i >= Q) continue;
        float* yrow = y + (bs + c0 + i) * xrow + h * P;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int p = tx * 4 + c;
          if (p < P)
            yrow[p] = __fadd_rn(yacc[r][c], __fmul_rn(ecum[i], yin[r][c]));
        }
      }
      __syncthreads();  // Cs is reloaded by the next strip
    }

    // ---- state update: decay past the chunk + this chunk's products -----
    const float cq = cum[Q - 1];
    float snew[4][NPT];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < NPT; ++c) snew[r][c] = 0.0f;
    for (int tj = 0; tj < n_strips; ++tj) {
      const int j0 = tj * kT;
      __syncthreads();
      for (int e = tid; e < kT * NP; e += kThreads) {
        const int r = e / NP, n = e % NP, j = j0 + r;
        Bs[r * Sm::kBrStride + n] =
            (j < Q && n < N) ? Bm[(bs + c0 + j) * N + n] : 0.0f;
      }
      for (int e = tid; e < kT * kPP; e += kThreads) {
        const int r = e / kPP, p = e % kPP, j = j0 + r;
        float xv = 0.0f;
        if (j < Q && p < P) {
          const float suffix =
              __fmul_rn(expf(__fsub_rn(cq, cum[j])), dts[j]);
          xv = __fmul_rn(x[(bs + c0 + j) * xrow + h * P + p], suffix);
        }
        Xs[r * kPP + p] = xv;
      }
      __syncthreads();
#pragma unroll 2
      for (int j = 0; j < kT; ++j) {
        const float4 xv = *reinterpret_cast<const float4*>(
            &Xs[j * kPP + ty * 4]);
        float bv[NPT];
#pragma unroll
        for (int c = 0; c < NPT; c += 4) {
          const float4 w = *reinterpret_cast<const float4*>(
              &Bs[j * Sm::kBrStride + tx * NPT + c]);
          bv[c] = w.x;
          bv[c + 1] = w.y;
          bv[c + 2] = w.z;
          bv[c + 3] = w.w;
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float xr = comp(xv, r);
#pragma unroll
          for (int c = 0; c < NPT; ++c)
            snew[r][c] = fmaf(xr, bv[c], snew[r][c]);
        }
      }
    }
    const float decay = expf(cq);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int p = ty * 4 + r;
#pragma unroll
      for (int c = 0; c < NPT; ++c) {
        const int n = tx * NPT + c;
        float& st = St[n * Sm::kSStride + p];
        st = __fadd_rn(__fmul_rn(st, decay), snew[r][c]);
      }
    }
  }

  __syncthreads();
  for (int i = tid; i < kPP * NP; i += kThreads) {
    const int p = i / NP, n = i % NP;
    if (p < P && n < N)
      final_state[sbase + p * N + n] = St[n * Sm::kSStride + p];
  }
}

template <int NP>
int launch(const float* x, const float* B, const float* C, const float* dt,
           const float* A, const float* init, float* y, float* fin, int Bn,
           int S, int H, int P, int N, int Q, cudaStream_t stream) {
  const int bytes = Smem<NP>::bytes(Q);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_kernel<NP>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(H, Bn);
  ssd_kernel<NP><<<grid, kThreads, bytes, stream>>>(x, B, C, dt, A, init, y,
                                                    fin, S, H, P, N, Q);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x [Bn, S, H, P], B/C [Bn, S, N], dt [Bn, S, H], A [H], init [Bn, H, P, N]
// or null, all contiguous fp32; y [Bn, S, H, P] and fin [Bn, H, P, N] are
// written. Q divides S; P <= 64, N <= 128.
extern "C" int ssd(const void* x, const void* B, const void* C,
                   const void* dt, const void* A, const void* init, void* y,
                   void* fin, int Bn, int S, int H, int P, int N, int Q,
                   void* stream) {
  if (Bn == 0 || H == 0) return 0;
  if (S < 1 || Q < 1 || S % Q != 0 || P < 1 || P > kPP || N < 1 || N > 128)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* xf = static_cast<const float*>(x);
  const float* bf = static_cast<const float*>(B);
  const float* cf = static_cast<const float*>(C);
  const float* df = static_cast<const float*>(dt);
  const float* af = static_cast<const float*>(A);
  const float* inf = static_cast<const float*>(init);
  float* yf = static_cast<float*>(y);
  float* ff = static_cast<float*>(fin);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N <= 64)
    return launch<64>(xf, bf, cf, df, af, inf, yf, ff, Bn, S, H, P, N, Q, s);
  return launch<128>(xf, bf, cf, df, af, inf, yf, ff, Bn, S, H, P, N, Q, s);
}
