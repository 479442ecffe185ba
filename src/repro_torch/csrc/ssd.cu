// ssd: the Mamba-2 state-space-duality chunked scan, fp32, with the chunks
// of a sequence in parallel and the products on the tensor cores.
//
// Replaces the Pallas kernel `ssd` (src/repro/kernels/ssd.py, `_kernel`),
// which walks the chunks of each (batch, head) in order on a sequential
// grid axis with the [P, N] state in VMEM. Per chunk of Q positions:
//     a = dt * A[h]                  cum = cumsum(a)
//     L = tril(exp(cum_i - cum_j))                 [Q, Q]
//     M = (C @ B^T) * L * dt_j                     [Q, Q]
//     y = M @ x  +  exp(cum)_i * (C @ state^T)     [Q, P]
//     state = exp(cum_Q) * state + ((suffix * dt) . x)^T B
// The state recurrence is linear, so each chunk's own contribution
// s_c = ((suffix * dt) . x_c)^T B_c can be formed before the state that
// enters the chunk is known. Three launches:
//   1. ssd_state_kernel, one block per (chunk, head, batch): cum, s_c
//      ([P, Q] x [Q, N]) and the chunk's last cum into a scratch;
//   2. ssd_pass_kernel, one thread per (batch, head, p, n): walks the
//      chunks in order, state = exp(cum_Q) * state + s_c, overwriting s_c
//      with the state entering chunk c; writes the final state (the one
//      the LM commit caches);
//   3. ssd_scan_kernel, one block per (128-row strip of a chunk, chunk,
//      head, batch): y_i = exp(cum_i) (C_i state_c^T) + sum_j<=i M_ij x_j.
// What bounds it on an H100: at the served shape (B = 4, S = 2048, H = 64,
// P = N = 64, Q = 256) the products on and below each chunk's diagonal
// (L is lower-triangular) and the two state products take 25.8 GFLOP
// against 279 MB of x/y/B/C/dt/state (and 67 MB more through the per-chunk
// states), so arithmetic bounds it. Every product runs as 3xTF32
// `mma.sync.m16n8k8` (common.cuh: x = big + small, three TF32 products,
// small x small dropped; fp32 accuracy, as csrc/flash_attention.cu shows
// at 2e-5): 77.5 GFLOP of tensor-core work, 0.157 ms at 495 TFLOP/s dense
// TF32 (0.386 ms for the same work in fp32 outside the tensor cores).
//
// Design:
//   * the TPU's sequential chunk axis becomes the pass (2): 2 x 33.5 MB of
//     per-chunk states at the served shape, elementwise and coalesced,
//     each thread's loads of 8 chunks in flight before its stores. The
//     two product kernels have B x H x S / Q = 2048 blocks of 4 warps (1)
//     and 4096 of 8 warps (3) at the served shape, where one block per
//     (batch, head) gave 256;
//   * a full [Q, Q] M at Q = 256 is 256 KB, so (3) forms it one 64-column
//     tile at a time for its strip of 128 rows: for column tile j at or
//     left of the strip's last row, G = C_i B_j^T, M = (G * L) * dt_j,
//     y_i += M x_j. A warp skips the tiles wholly right of its 16 rows
//     and, in a tile it crosses, the 8-column groups right of its last
//     row. Heavier strips launch first;
//   * each warp owns 16 rows. The contraction index of each 8-deep mma
//     step is permuted (fragment column t stands for index 2t, t + 4 for
//     2t + 1, in A and B alike), as in flash_attention: the M tile that
//     G's accumulator leaves in registers is then M x_j's A fragment as it
//     stands, so M never goes through shared memory;
//   * operands stay fp32 in shared memory, rows padded so that every
//     fragment load is free of bank conflicts; tiles are double-buffered
//     and fetched with cp.async (16 bytes a copy, zero-filled past Q, P
//     and N) where P, N and the bases allow, else plain loads;
//   * cum is a block scan (warp shuffles, then the warps' totals); (1)
//     and (3) scan the same way, so both see the same cum. L is
//     exp(cum_i - cum_j), the difference as the reference takes it, never
//     exp(cum_i) * exp(-cum_j), which over- and underflows;
//   * P <= 64 (padded to 64) and N <= 128 (padded to 64 or 128); a chunk
//     that is not a multiple of 64 (the divisor fallback the wrapper
//     repeats) stages zeros past Q and masks those rows and columns.
// exp is expf (no fast math); each multiply and add of the reference's
// elementwise formulas rounds on its own (-fmad=false).
#include "common.cuh"

namespace {

constexpr int kT = 64;           // rows of a staged x / B tile
constexpr int kPP = 64;          // P padded (P <= 64)
constexpr int kStateWarps = 4;   // (1): 16 of P's rows each
constexpr int kScanWarps = 8;    // (3): 16 strip rows each
constexpr int kStrip = 16 * kScanWarps;
constexpr int kCumWarps = 4;     // the block scan: passes of 128 positions
constexpr int kXS = kPP + 4;     // x tile row stride (floats)

// 16 bytes from global to shared memory, zero-filled when !in
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool in) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(in ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// rows [r0, r0 + ROWS) of a [*, cols] operand (row stride ld) into a
// shared tile W floats wide (row stride STRIDE), zeros past `limit` rows
// and past `cols`: cp.async where `vec` (cols, ld and the base in whole
// float4s), else plain loads and stores
template <int ROWS, int W, int STRIDE>
__device__ __forceinline__ void stage(float* dst, const float* src,
                                      long long ld, int r0, int limit,
                                      int cols, bool vec) {
  for (int i = threadIdx.x; i < ROWS * W / 4; i += blockDim.x) {
    const int r = i / (W / 4), d = 4 * (i % (W / 4)), p = r0 + r;
    float* to = dst + r * STRIDE + d;
    if (vec) {
      const bool in = p < limit && d < cols;
      cp_async16(to, in ? src + p * ld + d : src, in);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        to[e] = (p < limit && d + e < cols) ? src[p * ld + d + e] : 0.0f;
    }
  }
}

// dts[i] = dt[i * stride] and cum[i] = dts[0] a + ... + dts[i] a for
// i < len: each pass of 128 positions (the first 4 warps of the block)
// scans inside the warps (__shfl_up_sync), then adds the totals of the
// warps before and the carry of the passes before. cum[i] depends on
// positions <= i alone, so a block that scans a prefix gets the same
// values as one that scans the whole chunk, whatever its size.
__device__ void chunk_cumsum(const float* dt, int stride, float a, int len,
                             float* dts, float* cum, float* wsum) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const bool mine = warp < kCumWarps;
  float carry = 0.0f;
  for (int base = 0; base < len; base += 32 * kCumWarps) {
    const int i = base + threadIdx.x;
    float v = 0.0f;
    if (mine && i < len) {
      const float d = dt[static_cast<long long>(i) * stride];
      dts[i] = d;
      v = __fmul_rn(d, a);
    }
#pragma unroll
    for (int o = 1; o < 32; o *= 2) {
      const float u = __shfl_up_sync(0xffffffffu, v, o);
      if (lane >= o) v = __fadd_rn(u, v);
    }
    if (mine && lane == 31) wsum[warp] = v;
    __syncthreads();
    float pre = carry;
    for (int w = 0; w < warp && w < kCumWarps; ++w)
      pre = __fadd_rn(pre, wsum[w]);
    if (mine && i < len) cum[i] = __fadd_rn(pre, v);
    float total = carry;
#pragma unroll
    for (int w = 0; w < kCumWarps; ++w) total = __fadd_rn(total, wsum[w]);
    __syncthreads();  // wsum is rewritten by the next pass
    carry = total;
  }
}

template <int NP>  // N padded up to 64 or 128
struct StateSmem {
  static constexpr int kBS = NP + 4;           // Bs[2][kT][NP + 4]
  static constexpr int kX = kT * kXS;
  static constexpr int kB = kT * kBS;
  static int bytes(int Q) {
    const int nt = (Q + kT - 1) / kT;
    return (2 * kX + 2 * kB + 2 * Q + nt * kT + kCumWarps) * 4;
  }
};

template <int NP>
struct ScanSmem {
  static constexpr int kCS = NP + 8;           // Cs, Bs, St rows
  static constexpr int kC = kStrip * kCS;      // Cs[128][NP + 8]
  static constexpr int kB = kT * kCS;          // Bs[2][64][NP + 8]
  static constexpr int kX = kT * kXS;          // Xs[2][64][68]
  static int bytes(int Q) {
    return (kC + 2 * kB + 2 * kX + 2 * Q + kCumWarps) * 4;
  }
};

// (1) s_c[p][n] = sum_j x[j][p] w_j B[j][n], w_j = exp(cum_Q - cum_j) dt_j,
// written to states[b][h][c] ([P, N]); cum_Q to cqs[b][h][c]
template <int NP>
__global__ void __launch_bounds__(32 * kStateWarps)
ssd_state_kernel(const float* __restrict__ x, const float* __restrict__ Bm,
                 const float* __restrict__ dt, const float* __restrict__ A,
                 float* __restrict__ states, float* __restrict__ cqs, int S,
                 int H, int P, int N, int Q, int vx, int vb) {
  using Sm = StateSmem<NP>;
  constexpr int kBS = Sm::kBS;
  extern __shared__ __align__(16) float smem[];
  const int nt = (Q + kT - 1) / kT;
  float* Xs = smem;                  // two buffers
  float* Bs = Xs + 2 * Sm::kX;       // two buffers
  float* dts = Bs + 2 * Sm::kB;
  float* cum = dts + Q;
  float* wj = cum + Q;               // nt * 64, zero past Q
  float* wsum = wj + nt * kT;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z, nc = gridDim.x;
  const long long row0 = static_cast<long long>(b) * S +
                         static_cast<long long>(c) * Q;
  const long long xrow = static_cast<long long>(H) * P;
  const float* xb = x + row0 * xrow + static_cast<long long>(h) * P;
  const float* bb = Bm + row0 * N;

  stage<kT, kPP, kXS>(Xs, xb, xrow, 0, Q, P, vx);
  stage<kT, NP, kBS>(Bs, bb, N, 0, Q, N, vb);
  cp_async_commit();
  chunk_cumsum(dt + row0 * H + h, H, A[h], Q, dts, cum, wsum);
  const float cq = cum[Q - 1];
  for (int i = tid; i < nt * kT; i += blockDim.x)
    wj[i] = i < Q ? __fmul_rn(expf(__fsub_rn(cq, cum[i])), dts[i]) : 0.0f;
  if (tid == 0) cqs[(static_cast<long long>(b) * H + h) * nc + c] = cq;

  float acc[NP / 8][4];
#pragma unroll
  for (int j = 0; j < NP / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;
  const int p0 = warp * 16;  // this warp's rows of s_c: p0 + g, p0 + g + 8

  for (int tile = 0; tile < nt; ++tile) {
    const int buf = tile & 1;
    if (tile + 1 < nt) {  // the next tile's copies, in flight
      stage<kT, kPP, kXS>(Xs + (buf ^ 1) * Sm::kX, xb, xrow, (tile + 1) * kT,
                          Q, P, vx);
      stage<kT, NP, kBS>(Bs + (buf ^ 1) * Sm::kB, bb, N, (tile + 1) * kT, Q,
                         N, vb);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // this tile (and wj) landed for every thread
    if (p0 < P) {
      const float* xt = Xs + buf * Sm::kX;
      const float* bt = Bs + buf * Sm::kB;
      const float* w = wj + tile * kT;
#pragma unroll 2
      for (int kk = 0; kk < kT; kk += 8) {
        // A = (x . w)^T [p][j]: columns t, t + 4 stand for j, j + 1
        const int j = kk + 2 * t;
        const float* x0 = xt + j * kXS + p0 + g;
        uint32_t ab[4], as[4];
        split_tf32(__fmul_rn(x0[0], w[j]), ab[0], as[0]);
        split_tf32(__fmul_rn(x0[8], w[j]), ab[1], as[1]);
        split_tf32(__fmul_rn(x0[kXS], w[j + 1]), ab[2], as[2]);
        split_tf32(__fmul_rn(x0[kXS + 8], w[j + 1]), ab[3], as[3]);
        const float* b0 = bt + j * kBS + g;
#pragma unroll
        for (int n8 = 0; n8 < NP / 8; n8 += 8) {
          float bx[8], by[8];
#pragma unroll
          for (int jn = 0; jn < 8; ++jn) {
            bx[jn] = b0[8 * (n8 + jn)];
            by[jn] = b0[kBS + 8 * (n8 + jn)];
          }
          mma8_3xtf32(acc, n8, ab, as, bx, by);
        }
      }
    }
    __syncthreads();  // every warp is done with this buffer
  }

  if (p0 >= P) return;
  float* sc = states + ((static_cast<long long>(b) * H + h) * nc + c) *
                           static_cast<long long>(P) * N;
#pragma unroll
  for (int j = 0; j < NP / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int p = p0 + g + 8 * (e / 2), n = 8 * j + 2 * t + (e & 1);
      if (p < P && n < N) sc[p * N + n] = acc[j][e];
    }
}

// (2) states[b][h][c] <- the state entering chunk c; fin <- the state
// after the last chunk. One thread per (b, h, p, n).
__global__ void __launch_bounds__(256)
ssd_pass_kernel(float* __restrict__ states, const float* __restrict__ cqs,
                const float* __restrict__ init, float* __restrict__ fin,
                long long total, int PN, int nc) {
  const long long e = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (e >= total) return;
  const long long bh = e / PN;
  float* s = states + bh * nc * PN + e % PN;
  const float* cq = cqs + bh * nc;
  float st = init != nullptr ? init[e] : 0.0f;
  for (int c0 = 0; c0 < nc; c0 += 8) {
    // eight chunks' loads in flight before their stores
    float own[8], decay[8];
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (c0 + j < nc) {
        own[j] = s[static_cast<long long>(c0 + j) * PN];
        decay[j] = expf(cq[c0 + j]);
      }
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (c0 + j < nc) {
        s[static_cast<long long>(c0 + j) * PN] = st;
        st = __fadd_rn(__fmul_rn(st, decay[j]), own[j]);
      }
  }
  fin[e] = st;
}

// s <- (s * exp(cum_i - cum_j)) * dt_j: element e of s[jg] is row
// ia + 8 (e / 2), column ja + 8 jg + e % 2; kMasked zeroes j > i and
// rows past Q
template <bool kMasked>
__device__ __forceinline__ void form_m(float (&s)[8][4], const float* cum,
                                       const float* dts, int ia, int ja,
                                       int Q) {
#pragma unroll
  for (int jg = 0; jg < 8; ++jg)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = ia + 8 * (e / 2), j = ja + 8 * jg + (e & 1);
      float mv = 0.0f;
      if (!kMasked || (j <= i && i < Q)) {
        const float L = expf(__fsub_rn(cum[i], cum[j]));
        mv = __fmul_rn(__fmul_rn(s[jg][e], L), dts[j]);
      }
      s[jg][e] = mv;
    }
}

// acc += M x for one 8-column group of M (its C-layout fragment m, which
// is M's A fragment as it stands: columns t, t + 4 stand for 2t, 2t + 1)
// and the 8 rows of the x tile at xg
__device__ __forceinline__ void add_mx(float (&acc)[8][4], const float (&m)[4],
                                       const float* xg, int g, int t) {
  uint32_t ab[4], as[4];
  split_tf32(m[0], ab[0], as[0]);
  split_tf32(m[2], ab[1], as[1]);
  split_tf32(m[1], ab[2], as[2]);
  split_tf32(m[3], ab[3], as[3]);
  const float* x0 = xg + 2 * t * kXS + g;
  float bx[8], by[8];
#pragma unroll
  for (int pc = 0; pc < 8; ++pc) {
    bx[pc] = x0[8 * pc];
    by[pc] = x0[kXS + 8 * pc];
  }
  mma8_3xtf32(acc, 0, ab, as, bx, by);
}

// (3) y for one 128-row strip of one chunk
template <int NP>
__global__ void __launch_bounds__(32 * kScanWarps, 2)
ssd_scan_kernel(const float* __restrict__ x, const float* __restrict__ Bm,
                const float* __restrict__ Cm, const float* __restrict__ dt,
                const float* __restrict__ A, const float* __restrict__ states,
                float* __restrict__ y, int S, int H, int P, int N, int Q,
                int has_init, int vx, int vbc, int vs) {
  using Sm = ScanSmem<NP>;
  constexpr int kCS = Sm::kCS;
  extern __shared__ __align__(16) float smem[];
  float* Cs = smem;                  // the strip's C rows
  float* Bs = Cs + Sm::kC;           // two buffers; buffer 1 first holds St
  float* Xs = Bs + 2 * Sm::kB;       // two buffers
  float* dts = Xs + 2 * Sm::kX;
  float* cum = dts + Q;
  float* wsum = cum + Q;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int n_strips = (Q + kStrip - 1) / kStrip;
  const int nc = S / Q;
  const int si = n_strips - 1 - static_cast<int>(blockIdx.x) / nc;
  const int c = blockIdx.x % nc;
  const int h = blockIdx.y, b = blockIdx.z;
  const int i0 = si * kStrip;
  const int rows_end = min(Q, i0 + kStrip);        // rows i0 .. rows_end - 1
  const int n_tiles = (rows_end - 1) / kT + 1;     // column tiles j <= them
  const long long row0 = static_cast<long long>(b) * S +
                         static_cast<long long>(c) * Q;
  const long long xrow = static_cast<long long>(H) * P;
  const float* xb = x + row0 * xrow + static_cast<long long>(h) * P;
  const float* bb = Bm + row0 * N;
  const float* cb = Cm + row0 * N;
  const float* sb = states + ((static_cast<long long>(b) * H + h) * nc + c) *
                                 static_cast<long long>(P) * N;
  // no state enters the first chunk of a run without init_state
  const bool carry = c > 0 || has_init;

  stage<kStrip, NP, kCS>(Cs, cb, N, i0, Q, N, vbc);
  if (carry) stage<kT, NP, kCS>(Bs + Sm::kB, sb, N, 0, P, N, vs);
  stage<kT, NP, kCS>(Bs, bb, N, 0, Q, N, vbc);
  stage<kT, kPP, kXS>(Xs, xb, xrow, 0, Q, P, vx);
  cp_async_commit();
  chunk_cumsum(dt + row0 * H + h, H, A[h], rows_end, dts, cum, wsum);
  cp_async_wait<0>();
  __syncthreads();

  const int r = warp * 16 + g;  // this thread's strip rows: r, r + 8
  const int w_last = i0 + warp * 16 + 15;          // this warp's last row
  const bool live = i0 + warp * 16 < Q;
  const float* cw = Cs + r * kCS + 2 * t;
  float acc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;

  if (carry && live) {  // acc = exp(cum_i) * (C_i St^T)
    const float* st = Bs + Sm::kB + g * kCS + 2 * t;
#pragma unroll 2
    for (int kk = 0; kk < NP; kk += 8) {
      const float2 a0 = *reinterpret_cast<const float2*>(cw + kk);
      const float2 a1 = *reinterpret_cast<const float2*>(cw + 8 * kCS + kk);
      uint32_t ab[4], as[4];
      split_tf32(a0.x, ab[0], as[0]);
      split_tf32(a1.x, ab[1], as[1]);
      split_tf32(a0.y, ab[2], as[2]);
      split_tf32(a1.y, ab[3], as[3]);
      float bx[8], by[8];
#pragma unroll
      for (int pc = 0; pc < 8; ++pc) {
        const float2 v = *reinterpret_cast<const float2*>(
            st + 8 * pc * kCS + kk);
        bx[pc] = v.x;
        by[pc] = v.y;
      }
      mma8_3xtf32(acc, 0, ab, as, bx, by);
    }
    const int ia = i0 + r, ib = ia + 8;
    const float ea = ia < Q ? expf(cum[ia]) : 0.0f;
    const float eb = ib < Q ? expf(cum[ib]) : 0.0f;
#pragma unroll
    for (int pc = 0; pc < 8; ++pc) {
      acc[pc][0] = __fmul_rn(acc[pc][0], ea);
      acc[pc][1] = __fmul_rn(acc[pc][1], ea);
      acc[pc][2] = __fmul_rn(acc[pc][2], eb);
      acc[pc][3] = __fmul_rn(acc[pc][3], eb);
    }
  }

  for (int tj = 0; tj < n_tiles; ++tj) {
    const int buf = tj & 1;
    __syncthreads();  // buffer buf ^ 1 (St or tile tj - 1) is read
    if (tj + 1 < n_tiles) {  // the next tile's copies, in flight
      stage<kT, NP, kCS>(Bs + (buf ^ 1) * Sm::kB, bb, N, (tj + 1) * kT, Q,
                         N, vbc);
      stage<kT, kPP, kXS>(Xs + (buf ^ 1) * Sm::kX, xb, xrow, (tj + 1) * kT,
                          Q, P, vx);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // this tile landed for every thread
    const float* bt = Bs + buf * Sm::kB;
    const float* xt = Xs + buf * Sm::kX;
    const int j0 = tj * kT;
    // a tile wholly right of this warp's rows (or a warp past Q) adds
    // nothing
    if (!live || j0 > w_last) continue;

    // G = C_i B_j^T for this warp's 16 rows and the tile's 64 columns
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.0f;
    const float* bw = bt + g * kCS + 2 * t;
#pragma unroll 2
    for (int kk = 0; kk < NP; kk += 8) {
      const float2 a0 = *reinterpret_cast<const float2*>(cw + kk);
      const float2 a1 = *reinterpret_cast<const float2*>(cw + 8 * kCS + kk);
      uint32_t ab[4], as[4];
      split_tf32(a0.x, ab[0], as[0]);
      split_tf32(a1.x, ab[1], as[1]);
      split_tf32(a0.y, ab[2], as[2]);
      split_tf32(a1.y, ab[3], as[3]);
      float bx[8], by[8];
#pragma unroll
      for (int jg = 0; jg < 8; ++jg) {
        const float2 v = *reinterpret_cast<const float2*>(
            bw + 8 * jg * kCS + kk);
        bx[jg] = v.x;
        by[jg] = v.y;
      }
      mma8_3xtf32(s, 0, ab, as, bx, by);
    }

    // M = (G * L) * dt_j on and below the diagonal (a tile wholly below
    // it and above Q needs no mask)
    if (j0 + kT - 1 <= i0 + warp * 16 && w_last < Q)
      form_m<false>(s, cum, dts, i0 + r, j0 + 2 * t, Q);
    else
      form_m<true>(s, cum, dts, i0 + r, j0 + 2 * t, Q);

    // y_i += M x_j: s[jg] is M's A fragment for columns 8 jg .. 8 jg + 7
    // as it stands (fragment columns t, t + 4 stand for 2t, 2t + 1); the
    // groups right of this warp's last row are zero
    const int ng = min(8, (w_last - j0) / 8 + 1);
    if (ng == 8) {  // no branch between the groups: loads run ahead
#pragma unroll
      for (int jg = 0; jg < 8; ++jg)
        add_mx(acc, s[jg], xt + 8 * jg * kXS, g, t);
    } else {
#pragma unroll
      for (int jg = 0; jg < 8; ++jg)
        if (jg < ng) add_mx(acc, s[jg], xt + 8 * jg * kXS, g, t);
    }
  }

  float* yb = y + row0 * xrow + static_cast<long long>(h) * P;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int i = i0 + r + 8 * half;
    if (i >= Q) continue;
    float* yrow = yb + i * xrow;
#pragma unroll
    for (int pc = 0; pc < 8; ++pc)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int p = 8 * pc + 2 * t + e;
        if (p < P) yrow[p] = acc[pc][2 * half + e];
      }
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <int NP>
int launch(const float* x, const float* B, const float* C, const float* dt,
           const float* A, const float* init, float* y, float* fin,
           float* states, int Bn, int S, int H, int P, int N, int Q,
           cudaStream_t stream) {
  const int nc = S / Q;
  const int n_strips = (Q + kStrip - 1) / kStrip;
  const long long PN = static_cast<long long>(P) * N;
  const long long total = static_cast<long long>(Bn) * H * PN;
  float* cqs = states + total * nc;
  const int vx = P % 4 == 0 && aligned16(x);
  const int vb = N % 4 == 0 && aligned16(B);
  const int vbc = vb && aligned16(C);
  const int vs = N % 4 == 0 && aligned16(states);
  const int b1 = StateSmem<NP>::bytes(Q), b3 = ScanSmem<NP>::bytes(Q);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_state_kernel<NP>, cudaFuncAttributeMaxDynamicSharedMemorySize, b1);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(
      ssd_scan_kernel<NP>, cudaFuncAttributeMaxDynamicSharedMemorySize, b3);
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_state_kernel<NP><<<dim3(nc, H, Bn), 32 * kStateWarps, b1,
                         stream>>>(
      x, B, dt, A, states, cqs, S, H, P, N, Q, vx, vb);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = (total + 255) / 256;
  ssd_pass_kernel<<<static_cast<unsigned int>(blocks), 256, 0, stream>>>(
      states, cqs, init, fin, total, static_cast<int>(PN), nc);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_scan_kernel<NP><<<dim3(n_strips * nc, H, Bn), 32 * kScanWarps, b3,
                        stream>>>(
      x, B, C, dt, A, states, y, S, H, P, N, Q, init != nullptr, vx, vbc,
      vs);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x [Bn, S, H, P], B/C [Bn, S, N], dt [Bn, S, H], A [H], init [Bn, H, P, N]
// or null, all contiguous fp32; y [Bn, S, H, P] and fin [Bn, H, P, N] are
// written. scratch holds Bn * H * (S / Q) * (P * N + 1) floats: the
// per-chunk states, then each chunk's last cum (nothing needs zeroing).
// Q divides S; P <= 64, N <= 128; H and Bn ride on gridDim.y and .z.
extern "C" int ssd(const void* x, const void* B, const void* C,
                   const void* dt, const void* A, const void* init, void* y,
                   void* fin, void* scratch, int Bn, int S, int H, int P,
                   int N, int Q, void* stream) {
  if (Bn == 0 || H == 0) return 0;
  if (S < 1 || Q < 1 || S % Q != 0 || P < 1 || P > kPP || N < 1 ||
      N > 128 || H > 65535 || Bn > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* xf = static_cast<const float*>(x);
  const float* bf = static_cast<const float*>(B);
  const float* cf = static_cast<const float*>(C);
  const float* df = static_cast<const float*>(dt);
  const float* af = static_cast<const float*>(A);
  const float* inf = static_cast<const float*>(init);
  float* yf = static_cast<float*>(y);
  float* ff = static_cast<float*>(fin);
  float* sf = static_cast<float*>(scratch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N <= 64)
    return launch<64>(xf, bf, cf, df, af, inf, yf, ff, sf, Bn, S, H, P, N, Q,
                      s);
  return launch<128>(xf, bf, cf, df, af, inf, yf, ff, sf, Bn, S, H, P, N, Q,
                     s);
}

