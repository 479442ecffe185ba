// conv2d_f32: NHWC float32 convolution, SAME/VALID, stride s, + bias,
// optional relu, held to fp32 (1e-4 of the plain version) on the tensor
// cores; nothing from cuDNN.
//
// Replaces the Pallas kernel `conv2d` (src/repro/kernels/conv2d.py,
// `_kernel`), which held a whole padded image in VMEM and accumulated KH*KW
// shifted [W_out, Cin] x [Cin, Cout] matmuls per output row.
//
// What bounds it on an H100 (80GB HBM3, 700 W), at the shapes it is timed
// at: the bytes. The VAE stem (B=16, 128x256x3 -> 8, stride 2) moves
// 10.5 MB (3.1 us at 3.35 TB/s) for 0.45 GFLOP; CNet's stem in fp32
// (B=16, 256x256x2 -> 48) writes 201 MB (62.6 us) for 3.6 GFLOP (7.3 us
// even as 3xTF32 at 495 TFLOP/s).
//
// Design: the implicit-GEMM skeleton of csrc/igemm.cuh, shared with the
// int8 conv: persistent blocks (three of 8 warps an SM) walking tiles of
// 4 x 32-pixel sub-tiles with the filter slice staged once per block, a
// cp.async ring of three input-patch slots, zeros for SAME padding and
// overhang, each warp's outputs staged in shared memory and written as
// 16-byte stores. The product runs on `mma.sync.aligned.m16n8k8` TF32 in
// the 3xTF32 split flash_attention uses (common.cuh: big = x with its low
// 13 bits cleared, small = x - big, and a * b ~= small_a big_b + big_a
// small_b + big_a big_b, ~2^-20 relative). K is the filter's [KH, KW, Cin]
// order padded to 8. Cin a multiple of 4: A rows are read in place from
// the staged pixels by ldmatrix. Other Cin (the VAE stem's 3, CNet's fp32
// stem's 2): the patch rows are staged as 16-byte chunks and each lane
// loads its four A fragment values straight from them (K = 27 -> 32,
// 18 -> 24), no im2col pass and no padded copy of a pixel.
// Bias add (__fadd_rn) and relu (fmaxf) stay IEEE fp32. bc, the channels
// of a block, is at most 64 (one pass) and is halved until the block fits
// shared memory, so wide filters run as more channel blocks.
// What bounds it now (PERF.md): CNet's stem writes 201 MB and runs at
// ~2.7x that byte bound; the VAE stem (N = 8, 3 us of bytes) is set by the
// per-tile staging and setup, which its 8 channels do not amortize.
#include "igemm.cuh"

using igemm::Layout;
using igemm::Shape;
using igemm::Tile;
using igemm::kThreads;

struct ConvF32Args {
  const float* x;
  const float* w;
  const float* bias;
  float* out;
  Shape s;
  int Cout, bc, relu;
  Layout L;          // the block's shared-memory plan (host-computed)
  igemm::Walk walk;  // the tile walk's divisors (host-computed)
};

__host__ __device__ inline Layout f32_layout(int Cin, int bc, int KH, int KW,
                                             int stride, int msub) {
  return igemm::layout(Cin, bc, KH, KW, stride, 4, 8, 4, 4, msub);
}

// This thread's C fragments + bias, relu, into the warp's staging (pixels
// p0 at ob0, p0 + 8 at ob1; -1 past Ho/Wo); bias and relu compile-time.
// A fragment's two channels load their biases as one float2 and store as
// one 8-byte store where aligned.
template <bool kBias, bool kRelu>
__device__ __forceinline__ void epilogue(unsigned char* osm,
                                         const float (&acc)[8][4],
                                         const float* bsm, int nt, int ncv,
                                         int ob0, int ob1, int t4) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    if (j >= nt) break;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int n = 8 * j + 2 * t4 + e;
      if (n >= ncv) continue;
      const float bb = kBias ? bsm[n] : 0.0f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int ob = h ? ob1 : ob0;
        if (ob < 0) continue;
        float v = acc[j][e + 2 * h];
        if (kBias) v = __fadd_rn(v, bb);
        if (kRelu) v = fmaxf(v, 0.0f);
        *reinterpret_cast<float*>(osm + ob + 4 * n) = v;
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads, 3)
conv2d_f32_kernel(ConvF32Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Shape& s = a.s;
  const Layout& L = a.L;
  unsigned char* wsm = smem + L.off_w;
  float* bsm = reinterpret_cast<float*>(smem + L.off_q);
  int* tab = reinterpret_cast<int*>(smem + L.off_tab);
  unsigned char* zero = smem + L.off_zero;
  unsigned char* osm = smem + L.off_out;
  const unsigned char* x = reinterpret_cast<const unsigned char*>(a.x);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int co0 = blockIdx.y * a.bc;
  const int pb = 4 * s.Cin;
  const igemm::Walk& wk = a.walk;
  const long long ntiles = wk.ntiles;
  int tile = blockIdx.x;
  if (tile >= ntiles) return;

  for (int i = 0; i < L.slots - 1; ++i)
    igemm::ring_issue(smem, x, s, L, wk, i, pb, tid);
  // filter slice -> [nc8][Kp] floats, K-major per channel; zeros past K,
  // bc and Cout
  const int wst = L.w_stride / 4;
  for (int i = tid; i < L.nc8 * L.Kp; i += kThreads) {
    const int nl = i % L.nc8, kk = i / L.nc8;
    const int co = co0 + nl, wr = igemm::weight_row(L, a.s.Cin, a.s.KW, kk);
    reinterpret_cast<float*>(wsm)[nl * wst + kk] =
        (wr >= 0 && nl < a.bc && co < a.Cout)
            ? a.w[static_cast<long long>(wr) * a.Cout + co]
            : 0.0f;
  }
  for (int nl = tid; nl < L.nc8; nl += kThreads) {
    const int co = co0 + nl;
    bsm[nl] = (a.bias && nl < a.bc && co < a.Cout) ? a.bias[co] : 0.0f;
  }
  igemm::build_table(tab, s, L, 4, 4, tid);
  if (tid < 4) reinterpret_cast<uint32_t*>(zero)[tid] = 0;

  // ldmatrix rows of this lane (see conv2d_int8.cu): an 8-value K step is
  // 32 bytes, A rows (g, k 0-3), (g + 8, k 0-3), (g, k 4-7), (g + 8, k 4-7)
  const int mi = lane >> 3, r8 = lane & 7;
  const int arow = 16 * warp + r8 + 8 * (mi & 1), khalf = mi >> 1;
  const int in_lane = ((arow / igemm::kCols) * s.stride * L.pw +
                       (arow % igemm::kCols) * s.stride) * L.pix_stride;
  const unsigned char* wlane =
      wsm + (8 * (mi >> 1) + r8) * L.w_stride + 16 * (mi & 1);
  const int p0 = 16 * warp + g;
  const int nsteps = L.Kp / 8;
  const int nt = L.nc8 / 8;
  const int ncv = min(a.bc, a.Cout - co0);
  // the pass's plan, the same on every tile
  igemm::OutPass& o = *reinterpret_cast<igemm::OutPass*>(smem + L.off_plans);
  if (tid == 0) o = igemm::out_pass(a.Cout, co0, ncv, L.nchunk, 4);

  for (int it = 0; tile < ntiles; ++it, tile += gridDim.x) {
    const Tile tt = igemm::tile_at(tile, wk);
    igemm::ring_wait(L);
    __syncthreads();   // tile it landed; every warp is done with tile it - 1
    igemm::ring_issue(smem, x, s, L, wk, it + L.slots - 1, pb, tid);
    for (int m = 0; m < L.msub; ++m) {
      const Tile t{tt.b, tt.ho0 + igemm::kRows * m, tt.wo0};
      if (t.ho0 >= s.Ho) break;
      // the sub-tile's first patch row
      const int dr = igemm::kRows * m * s.stride;
      const unsigned char* patch =
          igemm::ring_slot(smem, L, it) + (L.inplace ? dr * L.pw * L.pix_stride
                                                     : 0);
      const int* rows = igemm::ring_rows(smem, L, it) + dr;
      const bool inside =
          t.wo0 * s.stride - s.pad_left >= 0 &&
          t.wo0 * s.stride - s.pad_left + L.pw <= s.W &&
          t.ho0 * s.stride - s.pad_top >= 0 &&
          t.ho0 * s.stride - s.pad_top + (igemm::kRows - 1) * s.stride +
                  s.KH <= s.H;
      float acc[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;
#pragma unroll 4
      for (int st = 0; st < nsteps; ++st) {
        uint32_t ar[4], ab[4], as[4];
        if (L.inplace) {
          igemm::ldmatrix_x4(ar, igemm::a_row(patch, nullptr, tab, zero, L,
                                              in_lane, arow, khalf, st));
        } else {
          // (g, k), (g + 8, k), (g, k + 4), (g + 8, k + 4), k = 8 st + t
#pragma unroll
          for (int e = 0; e < 4; ++e)
            ar[e] = igemm::a_value(patch, tab, rows, s, L, t, inside,
                                   p0 + 8 * (e & 1),
                                   8 * st + t4 + 4 * (e >> 1));
        }
#pragma unroll
        for (int e = 0; e < 4; ++e)
          split_tf32(__uint_as_float(ar[e]), ab[e], as[e]);
#pragma unroll
        for (int jj = 0; jj < 8; jj += 2) {
          if (jj < nt) {
            uint32_t br[4], bb[4], bs[4];
            igemm::ldmatrix_x4(br, wlane + 8 * jj * L.w_stride + 32 * st);
#pragma unroll
            for (int e = 0; e < 4; ++e)
              split_tf32(__uint_as_float(br[e]), bb[e], bs[e]);
            mma_tf32(acc[jj], as, bb[0], bb[1]);
            mma_tf32(acc[jj], ab, bs[0], bs[1]);
            mma_tf32(acc[jj], ab, bb[0], bb[1]);
            if (jj + 1 < nt) {
              mma_tf32(acc[jj + 1], as, bb[2], bb[3]);
              mma_tf32(acc[jj + 1], ab, bs[2], bs[3]);
              mma_tf32(acc[jj + 1], ab, bb[2], bb[3]);
            }
          }
        }
      }
      const int ob0 = igemm::out_offset(s, t, a.Cout, o, p0);
      const int ob1 = igemm::out_offset(s, t, a.Cout, o, p0 + 8);
      if (a.bias)
        a.relu ? epilogue<true, true>(osm, acc, bsm, nt, ncv, ob0, ob1, t4)
               : epilogue<true, false>(osm, acc, bsm, nt, ncv, ob0, ob1, t4);
      else
        a.relu ? epilogue<false, true>(osm, acc, bsm, nt, ncv, ob0, ob1, t4)
               : epilogue<false, false>(osm, acc, bsm, nt, ncv, ob0, ob1, t4);
      __syncwarp();
      igemm::store_pass(reinterpret_cast<unsigned char*>(a.out), osm, s, t,
                        a.Cout, o, warp, lane);
      __syncwarp();
    }
  }
  igemm::cp_async_wait<0>();
}

// Dynamic shared memory of one block (msub 4-row sub-tiles a tile)
extern "C" int conv2d_f32_smem_bytes(int Cin, int bc, int KH, int KW,
                                     int stride, int msub) {
  return f32_layout(Cin, bc, KH, KW, stride, msub).total;
}

// Output channels per block: min(round8(Cout), 64), halved (keeping a
// multiple of 8) until the block fits shared memory with one sub-tile a
// tile; 0 if 8 do not fit.
extern "C" int conv2d_f32_block_channels(int Cin, int Cout, int KH, int KW,
                                         int stride) {
  int bc = igemm::round_up(Cout, 8);
  if (bc > igemm::kNChunk) bc = igemm::kNChunk;
  while (bc > 8 &&
         conv2d_f32_smem_bytes(Cin, bc, KH, KW, stride, 1) > igemm::kSmemLimit)
    bc = igemm::round_up(bc / 2, 8);
  return conv2d_f32_smem_bytes(Cin, bc, KH, KW, stride, 1) > igemm::kSmemLimit
             ? 0
             : bc;
}

extern "C" int conv2d_f32(const void* x, const void* w, const void* bias,
                          void* out, int B, int H, int W, int Cin, int Cout,
                          int KH, int KW, int stride, int pad_top,
                          int pad_left, int Ho, int Wo, int bc, int msub,
                          int relu, void* stream) {
  if (B == 0 || Ho == 0 || Wo == 0 || Cout == 0) return 0;
  if (bc <= 0 || bc > igemm::kNChunk)
    return static_cast<int>(cudaErrorInvalidValue);
  const int ncb = (Cout + bc - 1) / bc;
  ConvF32Args a{static_cast<const float*>(x),
                static_cast<const float*>(w),
                static_cast<const float*>(bias),
                static_cast<float*>(out),
                Shape{B, H, W, Cin, KH, KW, stride, pad_top, pad_left, Ho, Wo},
                Cout, bc, relu, {}, {}};
  a.L = f32_layout(Cin, bc, KH, KW, stride, msub);
  a.walk = igemm::walk(a.s, a.L, 4 * Cin);
  const int smem = a.L.total;
  dim3 grid;
  const int rc = igemm::persistent_grid(conv2d_f32_kernel, smem, ncb,
                                        a.walk.ntiles, &grid);
  if (rc != 0) return rc;
  conv2d_f32_kernel<<<grid, kThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
