// conv2d_int8: NHWC int8 convolution, int32 accumulation, fused epilogue
// f32(acc) * (w_scale[co] * x_scale) (+ bias[co]), act, optional requant.
//
// Replaces the Pallas kernel `conv2d_int8` (src/repro/kernels/conv2d.py,
// `_kernel_int8`, both of its grids: whole Cout and `cout_per_block`),
// which loaded a whole padded image into VMEM and ran KH*KW shifted
// [W_out, Cin] x [Cin, Cout] matmuls per output row.
//
// What bounds it on an H100 (80GB HBM3, 700 W): at CNet's served shapes
// the bytes. B=16: the stem 256x256x2 -> 48 writes 50 MB of int8 (15.6 us
// at 3.35 TB/s) for 3.6 GOP (1.8 us at 1,979 TOP/s int8); act1
// 128x128x48 -> 48 moves 25 MB (7.5 us) for 10.9 GOP (5.5 us); act2
// 64x64x48 -> 32 f32 moves 11.5 MB (3.4 us). The three sum to 26.6 us.
//
// Design: an implicit GEMM on the tensor cores (csrc/igemm.cuh holds the
// skeleton it shares with the fp32 conv):
//   * M = a 4 x 32 sub-tile of output pixels (8 warps x 16; 1, 2 or 4
//     sub-tiles a tile), N = the block's channels in passes of up to 64,
//     K = (tap, ci); `mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32`,
//     int32 sums in registers. int32 sums are exact in any order, so the
//     result is bit-exact to the plain version whatever the K order;
//   * Cin a multiple of 16 (act1, act2, 3x3x128 -> 512): each 16-byte A
//     row lies in one tap and is read from the staged patch in place
//     (K = 9 x 48 = 432 -> 448). Other Cin (the stem's 2): each warp
//     builds its im2col rows in shared memory, one k32 step for the stem
//     (its filter rows' runs of 6 bytes padded to 8: K = 24 -> 32);
//   * the block's [KH, KW, Cin, bc] filter slice is staged once, K-major
//     per output channel (the B fragment's layout), zeros past Cin, bc
//     and Cw; blocks are persistent (three of 8 warps an SM, at most 80
//     registers a thread) and walk the tiles, with the next tiles' patches
//     in flight on a cp.async ring of three slots;
//   * the epilogue is common.cuh's (__fmaf_rn(f32(acc), w_scale * x_scale,
//     bias), act, then clip(rint(v * inv)) computed without conversion
//     instructions: requantize_code), compiled per (bias, act) so the
//     per-value code has no branch; each warp stages its outputs in
//     shared memory and writes them as 16-byte stores.
// What bounds it now (PERF.md): not the bytes. At the stem each output
// byte costs ~10 instructions of epilogue, and the im2col rows, the MMA
// phase, staging and store add more, so the kernel is ~8x its byte bound;
// act1 spends ~40% of its time in the MMA loop, where every warp loads
// the whole B fragment set by ldmatrix.
// The whole-Cout grid is the channel-blocked one with a single block of
// Cout channels (kCoutBlocks only names the two grids apart in a profile).
// The filter slice must fit a block: a whole 3x3x128 -> 512 filter does
// not, and the wrapper refuses it (channel blocks lift that limit).
//
// Weights may arrive padded ([KH, KW, Cin, Cw] with Cw >= Cout: the
// autotuner's prepacked arena); channels at or past Cw stage as zeros and
// channels at or past the logical Cout are never written. A pre-padded
// input is passed with its padded dims and pad offsets 0. x must be
// 16-byte aligned (the wrapper sees to it).
#include "igemm.cuh"

using igemm::Layout;
using igemm::Shape;
using igemm::Tile;
using igemm::kThreads;

struct ConvArgs {
  const int8_t* x;
  const int8_t* w;
  const float* w_scale;
  const float* bias;
  void* out;
  Shape s;
  int Cout;
  int Cw;    // channel stride of w, w_scale, bias (>= Cout when packed)
  int bc;    // output channels per block
  float x_scale;
  int act, requant;
  float inv;
  Layout L;          // the block's shared-memory plan (host-computed)
  igemm::Walk walk;  // the tile walk's divisors (host-computed)
};

__host__ __device__ inline Layout int8_layout(int Cin, int bc, int KH,
                                              int KW, int stride,
                                              int requant, int msub) {
  return igemm::layout(Cin, bc, KH, KW, stride, 1, 32, 16, requant ? 1 : 4,
                       msub);
}

// c (16 x 8, s32) += a (16 x 32, s8) x b (32 x 8, s8)
__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The block's filter slice -> [nc8][Kp] bytes, K-major per channel: each
// item reads 4 k-rows of 4 channels (one word each where aligned) and
// writes 4 channel words of 4 k each (a 4 x 4 byte transpose). Items go
// four to a thread at a time, so 16 loads are in flight.
__device__ __forceinline__ void stage_filter(unsigned char* wsm,
                                             const ConvArgs& a,
                                             const Layout& L, int co0,
                                             int tid) {
  const bool vec = a.Cw % 4 == 0 && co0 % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(a.w) % 4 == 0;
  const int nq = L.nc8 / 4, n = nq * (L.Kp / 4);
  for (int base = tid; base < n; base += 4 * kThreads) {
    uint32_t r[4][4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = base + u * kThreads;
      const int nl = 4 * (i % nq), k4 = i / nq;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k = igemm::weight_row(L, a.s.Cin, a.s.KW, 4 * k4 + j);
        r[u][j] = 0;
        if (i >= n || k < 0) continue;
        const int8_t* src =
            a.w + static_cast<long long>(k) * a.Cw + co0 + nl;
        if (vec && nl + 3 < a.bc && co0 + nl + 3 < a.Cw) {
          r[u][j] = __ldg(reinterpret_cast<const unsigned int*>(src));
        } else {
#pragma unroll
          for (int m = 0; m < 4; ++m)
            if (nl + m < a.bc && co0 + nl + m < a.Cw)
              r[u][j] |= static_cast<uint32_t>(static_cast<uint8_t>(src[m]))
                         << (8 * m);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = base + u * kThreads;
      if (i >= n) break;
      const int nl = 4 * (i % nq), k4 = i / nq;
      const uint32_t t0 = __byte_perm(r[u][0], r[u][1], 0x5140);
      const uint32_t t1 = __byte_perm(r[u][2], r[u][3], 0x5140);
      const uint32_t t2 = __byte_perm(r[u][0], r[u][1], 0x7362);
      const uint32_t t3 = __byte_perm(r[u][2], r[u][3], 0x7362);
      const uint32_t o[4] = {__byte_perm(t0, t1, 0x5410),
                             __byte_perm(t0, t1, 0x7632),
                             __byte_perm(t2, t3, 0x5410),
                             __byte_perm(t2, t3, 0x7632)};
#pragma unroll
      for (int m = 0; m < 4; ++m)
        *reinterpret_cast<uint32_t*>(wsm + (nl + m) * L.w_stride + 4 * k4) =
            o[m];
    }
  }
}

// common.cuh's requantize, clip(rint(v * inv), -127, 127), without the
// conversion units: clamping first and rounding after gives the same code
// (rint is monotone and the bounds are integers; NaN clamps to -127 either
// way), and adding 1.5 * 2^23 to a value in [-127, 127] rounds it to an
// integer, ties to even, in the low bits, whose low byte is the int8 code
__device__ __forceinline__ uint8_t requantize_code(float v, float inv) {
  const float y = fminf(fmaxf(__fmul_rn(v, inv), -127.0f), 127.0f);
  return static_cast<uint8_t>(__float_as_uint(__fadd_rn(y, 12582912.0f)));
}

template <bool kRequant, bool kBias, int kAct>
__device__ __forceinline__ void epilogue(unsigned char* osm,
                                         const int (&acc)[8][4],
                                         const float4* par, int nt, int ncv,
                                         int ob0, int ob1, int t4,
                                         float inv) {
  constexpr int elt = kRequant ? 1 : 4;
  const float* pf = reinterpret_cast<const float*>(par);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    if (j >= nt) break;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int n = 8 * j + 2 * t4 + e;
      if (n >= ncv) continue;
      const float d = pf[2 * n];
      const float bb = kBias ? pf[2 * n + 1] : 0.0f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int ob = h ? ob1 : ob0;
        if (ob < 0) continue;
        const float accf = __int2float_rn(acc[j][e + 2 * h]);
        const float v = apply_act(
            kBias ? __fmaf_rn(accf, d, bb) : __fmul_rn(accf, d), kAct);
        if (kRequant)
          osm[ob + n] = requantize_code(v, inv);
        else
          *reinterpret_cast<float*>(osm + ob + elt * n) = v;
      }
    }
  }
}

template <bool kRequant, bool kBias>
__device__ __forceinline__ void epilogue_act(int act, unsigned char* osm,
                                             const int (&acc)[8][4],
                                             const float4* par, int nt,
                                             int ncv, int ob0, int ob1,
                                             int t4, float inv) {
  if (act == ACT_RELU)
    epilogue<kRequant, kBias, ACT_RELU>(osm, acc, par, nt, ncv, ob0, ob1, t4,
                                        inv);
  else if (act == ACT_SIGMOID)
    epilogue<kRequant, kBias, ACT_SIGMOID>(osm, acc, par, nt, ncv, ob0, ob1,
                                           t4, inv);
  else
    epilogue<kRequant, kBias, ACT_NONE>(osm, acc, par, nt, ncv, ob0, ob1, t4,
                                        inv);
}

// kCoutBlocks only names the two grids apart in a profile; kRequant picks
// the int8 or the f32 output at compile time. Three blocks of 8 warps per
// SM (at most 80 registers a thread) hide the ring's and the epilogue's
// latencies better than two.
template <bool kCoutBlocks, bool kRequant>
__global__ void __launch_bounds__(kThreads, 3) conv2d_int8_kernel(ConvArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Shape& s = a.s;
  const Layout& L = a.L;
  unsigned char* wsm = smem + L.off_w;
  // (w_scale * x_scale, bias) of channels 2i, 2i + 1 at par[i]
  float4* par = reinterpret_cast<float4*>(smem + L.off_q);
  int* tab = reinterpret_cast<int*>(smem + L.off_tab);
  unsigned char* zero = smem + L.off_zero;
  unsigned char* A = smem + L.off_a;
  unsigned char* osm = smem + L.off_out;
  const unsigned char* x = reinterpret_cast<const unsigned char*>(a.x);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int co0 = blockIdx.y * a.bc;
  const igemm::Walk& wk = a.walk;
  const long long ntiles = wk.ntiles;
  int tile = blockIdx.x;
  if (tile >= ntiles) return;

  // the first tiles' patches are in flight while the filter is staged
  for (int i = 0; i < L.slots - 1; ++i)
    igemm::ring_issue(smem, x, s, L, wk, i, s.Cin, tid);
  stage_filter(wsm, a, L, co0, tid);
  for (int nl = tid; nl < L.nc8; nl += kThreads) {
    const int co = co0 + nl;
    const bool in = nl < a.bc && co < a.Cout;
    float* pp = reinterpret_cast<float*>(par) + 2 * nl;
    pp[0] = in ? __fmul_rn(a.w_scale[co], a.x_scale) : 0.0f;
    pp[1] = in && a.bias ? a.bias[co] : 0.0f;
  }
  igemm::build_table(tab, s, L, 1, 16, tid);
  if (tid < 4) reinterpret_cast<uint32_t*>(zero)[tid] = 0;

  // ldmatrix rows of this lane: A pixel row `arow` and K half `khalf`;
  // B channel row (n-tile jj + (mi >> 1), row r8), K half (mi & 1)
  const int mi = lane >> 3, r8 = lane & 7;
  const int arow = 16 * warp + r8 + 8 * (mi & 1), khalf = mi >> 1;
  const int in_lane = ((arow / igemm::kCols) * s.stride * L.pw +
                       (arow % igemm::kCols) * s.stride) * L.pix_stride;
  const unsigned char* wlane =
      wsm + (8 * (mi >> 1) + r8) * L.w_stride + 16 * (mi & 1);
  const int p0 = 16 * warp + g;        // C rows: pixels p0 and p0 + 8
  constexpr int elt = kRequant ? 1 : 4;     // output bytes a value
  const int nsteps = L.Kp / 32;
  // the passes' plans, the same on every tile
  igemm::OutPass* plans =
      reinterpret_cast<igemm::OutPass*>(smem + L.off_plans);
  for (int n0 = igemm::kNChunk * tid; n0 < L.nc8;
       n0 += igemm::kNChunk * kThreads) {
    const int ncv = min(min(igemm::kNChunk, a.bc - n0), a.Cout - co0 - n0);
    plans[n0 / igemm::kNChunk] =
        igemm::out_pass(a.Cout, co0 + n0, ncv, L.nchunk, elt);
  }

  for (int it = 0; tile < ntiles; ++it, tile += gridDim.x) {
    const Tile tt = igemm::tile_at(tile, wk);
    igemm::ring_wait(L);
    __syncthreads();   // tile it landed; every warp is done with tile it - 1
    igemm::ring_issue(smem, x, s, L, wk, it + L.slots - 1, s.Cin, tid);
    for (int m = 0; m < L.msub; ++m) {
      const Tile t{tt.b, tt.ho0 + igemm::kRows * m, tt.wo0};
      if (t.ho0 >= s.Ho) break;
      // the sub-tile's first patch row
      const int dr = igemm::kRows * m * s.stride;
      const unsigned char* patch =
          igemm::ring_slot(smem, L, it) + (L.inplace ? dr * L.pw * L.pix_stride
                                                     : 0);
      if (!L.inplace) {
        igemm::build_im2col(A, patch, tab, igemm::ring_rows(smem, L, it) + dr,
                            s, L, t, warp, lane);
        __syncwarp();
      }
      for (int n0 = 0; n0 < L.nc8; n0 += igemm::kNChunk) {
        const int nt = min(8, (L.nc8 - n0) / 8);
        const int ncv = min(min(igemm::kNChunk, a.bc - n0), a.Cout - co0 - n0);
        if (ncv <= 0) break;
        int acc[8][4];
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[j][e] = 0;
        const unsigned char* wn = wlane + n0 * L.w_stride;
#pragma unroll 4
        for (int st = 0; st < nsteps; ++st) {
          uint32_t af[4];
          igemm::ldmatrix_x4(af, igemm::a_row(patch, A, tab, zero, L, in_lane,
                                              arow, khalf, st));
#pragma unroll
          for (int jj = 0; jj < 8; jj += 2) {
            if (jj < nt) {
              uint32_t bf[4];
              igemm::ldmatrix_x4(bf, wn + 8 * jj * L.w_stride + 32 * st);
              mma_s8(acc[jj], af, bf[0], bf[1]);
              if (jj + 1 < nt) mma_s8(acc[jj + 1], af, bf[2], bf[3]);
            }
          }
        }
        // epilogue -> staged output -> 16-byte stores
        const igemm::OutPass& o = plans[n0 / igemm::kNChunk];
        const int ob0 = igemm::out_offset(s, t, a.Cout, o, p0);
        const int ob1 = igemm::out_offset(s, t, a.Cout, o, p0 + 8);
        if (a.bias)
          epilogue_act<kRequant, true>(a.act, osm, acc, par + n0 / 2, nt,
                                       ncv, ob0, ob1, t4, a.inv);
        else
          epilogue_act<kRequant, false>(a.act, osm, acc, par + n0 / 2,
                                        nt, ncv, ob0, ob1, t4, a.inv);
        __syncwarp();
        igemm::store_pass(static_cast<unsigned char*>(a.out), osm, s, t,
                          a.Cout, o, warp, lane);
        __syncwarp();                  // this warp's staging is free
      }
    }
  }
  igemm::cp_async_wait<0>();
}

// Dynamic shared memory of one block (int8 output when requant != 0,
// msub 4-row sub-tiles a tile)
extern "C" int conv2d_int8_smem_bytes(int Cin, int bc, int KH, int KW,
                                      int stride, int requant, int msub) {
  return int8_layout(Cin, bc, KH, KW, stride, requant, msub).total;
}

template <bool kCoutBlocks, bool kRequant>
static int launch(ConvArgs a, int ncb, int msub, void* stream) {
  a.L = int8_layout(a.s.Cin, a.bc, a.s.KH, a.s.KW, a.s.stride, kRequant,
                    msub);
  a.walk = igemm::walk(a.s, a.L, a.s.Cin);
  const int smem = a.L.total;
  dim3 grid;
  const int rc = igemm::persistent_grid(
      conv2d_int8_kernel<kCoutBlocks, kRequant>, smem, ncb, a.walk.ntiles,
      &grid);
  if (rc != 0) return rc;
  conv2d_int8_kernel<kCoutBlocks, kRequant>
      <<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// H, W are the dims of x as stored (the padded dims when the caller staged
// the padding, with pad_top = pad_left = 0); Cw is w's channel stride.
// bc == 0 runs the whole-Cout grid (one block of Cout channels); bc > 0
// runs the channel-blocked grid with ceil(Cout / bc) blocks. msub is the
// 4-row sub-tiles of a tile (1, 2 or 4).
extern "C" int conv2d_int8(const void* x, const void* w, const void* w_scale,
                           const void* bias, void* out, int B, int H, int W,
                           int Cin, int Cout, int Cw, int KH, int KW,
                           int stride, int pad_top, int pad_left, int Ho,
                           int Wo, int bc, int msub, float x_scale, int act,
                           int requant, float inv, void* stream) {
  if (B == 0 || Ho == 0 || Wo == 0 || Cout == 0) return 0;
  const bool blocks = bc > 0;
  if (!blocks) bc = Cout;
  const int ncb = (Cout + bc - 1) / bc;
  ConvArgs a{static_cast<const int8_t*>(x),
             static_cast<const int8_t*>(w),
             static_cast<const float*>(w_scale),
             static_cast<const float*>(bias),
             out,
             Shape{B, H, W, Cin, KH, KW, stride, pad_top, pad_left, Ho, Wo},
             Cout, Cw, bc, x_scale, act, requant, inv, {}, {}};
  if (blocks)
    return requant ? launch<true, true>(a, ncb, msub, stream)
                   : launch<true, false>(a, ncb, msub, stream);
  return requant ? launch<false, true>(a, ncb, msub, stream)
                 : launch<false, false>(a, ncb, msub, stream);
}
