// The implicit-GEMM skeleton both convolution kernels share
// (csrc/conv2d_int8.cu on int8 mma.sync m16n8k32, csrc/conv2d_f32.cu on
// 3xTF32 mma.sync m16n8k8). What it provides:
//
//   * the GEMM view: M is a sub-tile of 4 x 32 output pixels of one image
//     (8 warps x 16 pixels); a tile is msub sub-tiles stacked (4 msub
//     rows, one staged patch), msub in {1, 2, 4} chosen by the wrapper to
//     spread the per-tile work where the blocks stay small and the tiles
//     many. N is the block's output channels, K the filter's taps in
//     [KH, KW] order, each tap's channels contiguous; K is zero-padded at
//     its end to the MMA depth (k_index has the map);
//   * persistent blocks: gridDim.y is the channel block, and the blocks of
//     one channel block walk the tiles (tile += gridDim.x), so the filter
//     slice is staged once per block, not once per tile;
//   * a ring of three input-patch slots (two where three do not fit)
//     filled by cp.async: the next tiles' patches are in flight while this
//     tile is computed. SAME padding and tile overhang are produced as
//     zeros, never as a padded copy of the input;
//   * one block barrier per tile (the ring's): each warp builds its own
//     im2col rows, stages and stores its own 16 pixels' outputs, so the
//     rest is ordered by __syncwarp and the warps drift apart freely;
//   * two ways to read A, a pure function of the shape:
//       - in place (Cin a multiple of 16 int8, of 4 tf32): each staged
//         pixel holds its Cin values, copied 16 bytes (else 8) at a time
//         and zero-filled outside the image, the pixel stride padded so
//         that the 8 rows of an ldmatrix fall on distinct banks; a table
//         gives each 16-byte A row's offset in the patch;
//       - by rows (other Cin: the int8 stem's 2, the tf32 stems' 2 and 3):
//         each patch row is copied as the 16-byte-aligned chunks that
//         cover its in-image bytes (whatever neighbouring bytes those
//         chunks carry are never read). int8 pads each filter row's run of
//         KW * Cin values to whole 32-bit words in K (6 -> 8 bytes for the
//         stem) and each warp builds its rows of the [128, K] A tile in
//         shared memory: on a sub-tile whose patch lies inside the image,
//         each A word is one unaligned 4-byte read of a patch row (two
//         loads and a funnel shift), else value by value with zeros
//         outside. tf32 A fragments are single 4-byte values, so each lane
//         loads its four straight from the patch rows (a_value);
//   * A and B fragments come from shared memory by ldmatrix (four 8 x 16
//     byte matrices a lane), one B load covering two n-tiles;
//   * each warp stages its outputs in shared memory and writes them as
//     16-byte stores of contiguous output: its 16 pixels (half a tile row)
//     as one run when the pass holds every channel of a pixel, else each
//     pixel's run of the pass's channels. Each staged run starts at the
//     same offset mod 16 as its global address, so every aligned 16-byte
//     global chunk is one aligned 16-byte shared-memory load; only ragged
//     ends go byte by byte. Output indices are 64-bit.
//
// tests/test_torch_conv_igemm.py mirrors this index map in numpy and holds
// it against the JAX reference on the CPU.
#pragma once

#include "common.cuh"

namespace igemm {

constexpr int kRows = 4;                 // output rows per sub-tile
constexpr int kCols = 32;                // output columns per pixel tile
constexpr int kPix = kRows * kCols;      // M of a sub-tile: 8 warps x 16
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;    // 16 pixels of a tile each
constexpr int kNChunk = 64;              // channels per pass over a tile
constexpr int kSmemLimit = 232448;       // bytes a Hopper block can use
constexpr int kPlanBytes = 32;           // one pass's OutPass

struct Shape {
  int B, H, W, Cin, KH, KW, stride, pad_top, pad_left, Ho, Wo;
};

__host__ __device__ inline int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

// a row of `bytes` (a multiple of 16) padded so its 32-bit word count is
// 4 mod 8: the 8 rows an ldmatrix reads then fall on 8 distinct groups of
// 4 banks
__host__ __device__ inline int conflict_free(int bytes) {
  return bytes % 32 == 0 ? bytes + 16 : bytes;
}

// Shared-memory plan of one block. `elt` is the input element size,
// `depth` the MMA's K (32 int8, 8 tf32), `half` the K of one 16-byte A row
// (16 int8, 4 tf32), `out_elt` the output element size and `msub` the
// sub-tiles of a tile. A is read in place when Cin is a multiple of
// `half`, else by rows.
struct Layout {
  int inplace;          // A read in place from the patch, else im2col
  int msub;             // 4-row sub-tiles per tile
  int K, Kp;            // GEMM depth, padded to `depth`
  int run;              // K values per filter row
  int steps;            // in place: table entries; else Kp
  int ph, pw;           // patch rows and columns
  int pix_stride;       // in place: bytes per staged pixel
  int row_stride;       // im2col: bytes per staged patch row
  int patch_bytes;      // one ring slot
  int slots;            // ring slots: 3 where they fit, else 2
  int a_stride;         // im2col: bytes per row of the A tile
  int nc8;              // channels with a filter row (bc rounded up to 8)
  int w_stride;         // bytes per staged filter channel (K-major)
  int nchunk;           // channels per pass
  int off_w, off_q, off_tab, off_rows, off_plans, off_zero, off_patch;
  int off_a, off_out;
  int total;
};

__host__ __device__ inline Layout layout(int Cin, int bc, int KH, int KW,
                                         int stride, int elt, int depth,
                                         int half, int out_elt, int msub) {
  Layout L;
  L.inplace = Cin % half == 0;
  L.msub = msub;
  L.run = round_up(KW * Cin * elt, 4) / elt;
  L.K = KH * L.run;
  L.Kp = round_up(L.K, depth);
  L.ph = (kRows * msub - 1) * stride + KH;
  L.pw = (kCols - 1) * stride + KW;
  L.pix_stride = conflict_free(Cin * elt);
  L.row_stride = round_up(L.pw * Cin * elt, 16) + 32;
  L.patch_bytes = L.inplace ? round_up(L.ph * L.pw * L.pix_stride, 16)
                            : L.ph * L.row_stride;
  L.steps = L.inplace ? L.Kp / half : L.Kp;
  L.a_stride = conflict_free(L.Kp * elt);
  L.nc8 = round_up(bc, 8);
  L.w_stride = conflict_free(L.Kp * elt);
  L.nchunk = L.nc8 < kNChunk ? L.nc8 : kNChunk;
  const int out_px = round_up(out_elt * L.nchunk, 16) + 16;
  const int out_seg = round_up(out_elt * 16 * L.nchunk, 16) + 16;
  const int out_bytes = kPix * out_px > kWarps * out_seg ? kPix * out_px
                                                         : kWarps * out_seg;
  // filter rows to a multiple of 16: an n-tile pair's ldmatrix may read
  // the (unused) rows of the tile after the last
  L.off_w = 0;
  L.off_q = L.off_w + round_up(L.nc8, 16) * L.w_stride;
  L.off_tab = L.off_q + 2 * 4 * L.nc8;
  L.off_rows = L.off_tab + round_up((L.inplace ? 4 : 8) * L.steps, 16);
  L.off_plans = L.off_rows + round_up(4 * 3 * L.ph, 16);
  L.off_zero = L.off_plans + kPlanBytes * ((L.nc8 + kNChunk - 1) / kNChunk);
  L.off_patch = L.off_zero + 16;
  for (L.slots = 3; L.slots >= 2; --L.slots) {
    L.off_a = L.off_patch + L.slots * L.patch_bytes;
    // tf32 reads A straight from the patch rows (no A tile); int8 builds
    // its im2col rows
    L.off_out = L.off_a + (L.inplace || elt == 4 ? 0 : kPix * L.a_stride);
    L.total = L.off_out + out_bytes;
    if (L.total <= kSmemLimit) break;
  }
  if (L.slots < 2) L.slots = 2;
  return L;
}

// n / d for 0 <= n < 2^31 by a multiply-high and a shift (Granlund and
// Montgomery's round-up method: l = ceil(log2 d), m = floor(2^32 (2^l -
// d) / d) + 1, n / d = (umulhi(n, m) + n) >> l), set up on the host for
// the divisors the tile walk would otherwise divide by on every tile
struct FastDiv {
  unsigned m, l;
  __host__ __device__ void init(unsigned d) {
    l = 0;
    while ((1ull << l) < d) ++l;
    m = static_cast<unsigned>(((1ull << 32) * ((1ull << l) - d)) / d + 1);
  }
  __device__ __forceinline__ int operator()(int n) const {
    const unsigned u = static_cast<unsigned>(n);
    return static_cast<int>((__umulhi(u, m) + u) >> l);
  }
};

struct Tile {
  int b, ho0, wo0;
};

__host__ __device__ inline long long n_tiles(const Shape& s, int rows) {
  return static_cast<long long>(s.B) * ((s.Ho + rows - 1) / rows) *
         ((s.Wo + kCols - 1) / kCols);
}

// What the tile walk divides by, computed on the host and passed with
// the layout as kernel parameters (constant memory, not registers): tiles
// per image and per tile row, the 16-byte copies per staged pixel, the
// patch columns
struct Walk {
  long long ntiles;
  int trows, tw, per_image;   // output rows of a tile, tiles a row, image
  FastDiv by_image, by_tw, by_q, by_pw;
};

inline Walk walk(const Shape& s, const Layout& L, int pb) {
  Walk w;
  w.trows = kRows * L.msub;
  w.ntiles = n_tiles(s, w.trows);
  w.tw = (s.Wo + kCols - 1) / kCols;
  w.per_image = w.tw * ((s.Ho + w.trows - 1) / w.trows);
  w.by_image.init(w.per_image);
  w.by_tw.init(w.tw);
  w.by_q.init(pb / 16 > 0 ? pb / 16 : 1);
  w.by_pw.init(L.pw);
  return w;
}

__device__ __forceinline__ Tile tile_at(int id, const Walk& w) {
  Tile t;
  t.b = w.by_image(id);
  const int rem = id - t.b * w.per_image;
  const int row = w.by_tw(rem);
  t.ho0 = row * w.trows;
  t.wo0 = (rem - row * w.tw) * kCols;
  return t;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes to shared memory: the first `n` from `src`, zeros after
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int n) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ uint32_t ld32(const unsigned char* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Four 8 x 16-byte matrices: lane l gives the address of row l % 8 of
// matrix l / 8 and receives, for each matrix, the 4 bytes at row l / 4,
// bytes 4 (l % 4) .. +3: an mma.sync A or B fragment register (int8
// m16n8k32 and tf32 m16n8k8 alike)
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const unsigned char* row) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(row)));
}

// The low 4 bits of the byte offset of the first patch column of patch row
// `hi` (computed mod 2^32, which keeps them: wi0 may be negative)
__device__ __forceinline__ int row_shift(const Shape& s, const Tile& t,
                                         int hi, int pb) {
  const unsigned wi0 =
      static_cast<unsigned>(t.wo0 * s.stride - s.pad_left);
  const unsigned u =
      ((static_cast<unsigned>(t.b) * s.H + hi) * s.W + wi0) * pb;
  return static_cast<int>(u & 15u);
}

// Start the copies of tile `t`'s input patch into `dst` (no commit).
// `pb` is bytes per input pixel (Cin * elt).
__device__ __forceinline__ void stage_patch(unsigned char* dst,
                                            const unsigned char* x,
                                            const Shape& s, const Layout& L,
                                            const Walk& w, const Tile& t,
                                            int pb, int tid) {
  const int hi0 = t.ho0 * s.stride - s.pad_top;
  const int wi0 = t.wo0 * s.stride - s.pad_left;
  if (L.inplace) {
    // whole pixels of pb bytes (a multiple of 16); outside -> zeros
    const int q = pb / 16;
    const int n = L.ph * L.pw * q;
#pragma unroll 4
    for (int i = tid; i < n; i += kThreads) {
      const int pix = w.by_q(i), j = i - pix * q;
      const int pr = w.by_pw(pix), pc = pix - pr * L.pw;
      const int hi = hi0 + pr, wi = wi0 + pc;
      const bool in = hi >= 0 && hi < s.H && wi >= 0 && wi < s.W;
      const unsigned char* src =
          in ? x + ((static_cast<long long>(t.b) * s.H + hi) * s.W + wi) *
                           pb + 16 * j
             : x;
      cp_async16(dst + pix * L.pix_stride + 16 * j, src, in ? 16 : 0);
    }
    return;
  }
  // im2col: per in-image row, the aligned chunks covering its in-image
  // bytes; build_im2col and a_value never read what lies outside them
  const int wl = wi0 > 0 ? wi0 : 0;
  const int wh = wi0 + L.pw < s.W ? wi0 + L.pw : s.W;
  if (wl >= wh) return;
  const long long total = static_cast<long long>(s.B) * s.H * s.W * pb;
  const int per_row = L.row_stride / 16;
#pragma unroll 4
  for (int i = tid; i < L.ph * per_row; i += kThreads) {
    const int pr = i / per_row, k = i - pr * per_row;
    const int hi = hi0 + pr;
    if (hi < 0 || hi >= s.H) continue;
    const long long row = (static_cast<long long>(t.b) * s.H + hi) * s.W;
    const long long g0 = (row + wi0) * pb;           // patch column 0
    const long long base = g0 - (g0 & 15);
    const long long ga = (row + wl) * pb, gb = (row + wh) * pb;
    const long long c = ga - (ga & 15) + 16LL * k;
    if (c >= gb) continue;
    const long long left = total - c;
    cp_async16(dst + pr * L.row_stride + (c - base), x + c,
               left < 16 ? static_cast<int>(left) : 16);
  }
}

// The patch ring: slot it % slots holds the patch of the block's it-th
// tile (and, for im2col, its patch rows' offsets). Before the walk,
// ring_issue(0 .. slots - 2); at step it, ring_wait, a block barrier (the
// only one a tile takes: tile it has landed for every thread, and every
// warp is done with tile it - 1), then ring_issue(it + slots - 1) into
// tile it - 1's slot. One commit group per issue, empty past the last
// tile, so the count stays exact.
__device__ __forceinline__ unsigned char* ring_slot(unsigned char* smem,
                                                   const Layout& L, int it) {
  return smem + L.off_patch + (it % L.slots) * L.patch_bytes;
}

__device__ __forceinline__ int* ring_rows(unsigned char* smem,
                                          const Layout& L, int it) {
  return reinterpret_cast<int*>(smem + L.off_rows) + (it % L.slots) * L.ph;
}

__device__ __forceinline__ void ring_issue(unsigned char* smem,
                                           const unsigned char* x,
                                           const Shape& s, const Layout& L,
                                           const Walk& w, int it, int pb,
                                           int tid) {
  const long long tile = blockIdx.x + static_cast<long long>(it) * gridDim.x;
  if (tile < w.ntiles) {
    const Tile t = tile_at(static_cast<int>(tile), w);
    stage_patch(ring_slot(smem, L, it), x, s, L, w, t, pb, tid);
    // im2col: each patch row's offset in the slot, -1 outside the image
    if (!L.inplace && tid < L.ph) {
      const int hi = t.ho0 * s.stride - s.pad_top + tid;
      ring_rows(smem, L, it)[tid] =
          hi >= 0 && hi < s.H ? tid * L.row_stride + row_shift(s, t, hi, pb)
                              : -1;
    }
  }
  cp_async_commit();
}

__device__ __forceinline__ void ring_wait(const Layout& L) {
  if (L.slots == 3)
    cp_async_wait<1>();
  else
    cp_async_wait<0>();
}

// In place: for table entry h (K values h * half ..: one 16-byte A row),
// the byte offset of (tap, first channel) in the patch, or -1 past K.
// Im2col: for each k < Kp, tab[k] = r | c << 16 (r = 0xffff for padding)
// and tab[Kp + k] = the byte offset of (c, ci) in a patch row's run.

// The (filter row r, column c, channel ci) of K index kk, false for
// padding (past K, past a row's KW taps)
__host__ __device__ inline bool k_index(const Layout& L, int Cin, int KW,
                                        int kk, int& r, int& c, int& ci) {
  r = kk / L.run;
  const int j = kk - r * L.run;
  c = j / Cin;
  ci = j - c * Cin;
  return kk < L.K && c < KW;
}

// The HWIO weight row of K index kk, or -1 for padding
__host__ __device__ inline int weight_row(const Layout& L, int Cin, int KW,
                                          int kk) {
  int r, c, ci;
  return k_index(L, Cin, KW, kk, r, c, ci) ? (r * KW + c) * Cin + ci : -1;
}
__device__ __forceinline__ void build_table(int* tab, const Shape& s,
                                            const Layout& L, int elt,
                                            int half, int tid) {
  for (int h = tid; h < L.steps; h += kThreads) {
    int r, c, ci;
    if (L.inplace) {
      // a 16-byte A row: `half` values of one tap
      const int kk = h * half;
      const bool in = kk < L.K;
      k_index(L, s.Cin, s.KW, kk, r, c, ci);
      tab[h] = in ? (r * L.pw + c) * L.pix_stride + ci * elt : -1;
    } else {
      const bool in = k_index(L, s.Cin, s.KW, h, r, c, ci);
      tab[h] = in ? r | (c << 16) : 0xffff;
      tab[L.Kp + h] = in ? (c * s.Cin + ci) * elt : 0;
    }
  }
}

// A warp's 16 int8 im2col rows (pixels 16 warp ..) of sub-tile t from
// the tile's staged patch (`rows`: the offsets of the sub-tile's patch
// rows): zeros outside the image and past K. A lane keeps one 32-bit
// column kw of the rows (its 4 values of K decoded once) and walks the
// warp's pixels: the columns are spread over a power of two of lanes, so
// that column and pixel step are a mask and a shift. Only this warp reads
// these rows, so a __syncwarp publishes them.
__device__ __forceinline__ void build_im2col(unsigned char* A,
                                             const unsigned char* patch,
                                             const int* tab, const int* rows,
                                             const Shape& s, const Layout& L,
                                             const Tile& t, int warp,
                                             int lane) {
  const int pb = s.Cin, kwc = s.KW * s.Cin;   // bytes a pixel, a row's run
  const int words = L.Kp / 4;
  int lanes = 1;
  while (lanes < words && lanes < 32) lanes *= 2;
  const int shift = __ffs(lanes) - 1;
  const int wi0 = t.wo0 * s.stride - s.pad_left;
  const int hi0 = t.ho0 * s.stride - s.pad_top;
  const unsigned pspan = static_cast<unsigned>(s.W);   // input columns
  // a sub-tile whose whole patch lies in the image needs no bounds checks
  const bool inside = wi0 >= 0 && wi0 + L.pw <= s.W && hi0 >= 0 &&
                      hi0 + (kRows - 1) * s.stride + s.KH <= s.H;
  for (int kw = lane & (lanes - 1); kw < words; kw += lanes) {
    int r[4], c[4], off[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int rc = tab[4 * kw + e];
      r[e] = rc & 0xffff;
      c[e] = (rc >> 16) + wi0;            // + pcb: the input column
      off[e] = tab[L.Kp + 4 * kw + e];
    }
    // values e, e + 1 of one tap at an even offset load as one u16 (the
    // stem's Cin = 2 loads every word as two)
    bool pair[2];
#pragma unroll
    for (int q = 0; q < 2; ++q)
      pair[q] = r[2 * q] != 0xffff && r[2 * q] == r[2 * q + 1] &&
                c[2 * q] == c[2 * q + 1] &&
                off[2 * q + 1] == off[2 * q] + 1 &&
                (off[2 * q] & 1) == 0 && (pb & 1) == 0;
    // inside the image the word is bytes [jb, jb + 4) of filter row rw's
    // run, contiguous in the patch row (masked past the run's kwc bytes)
    const int rw = 4 * kw / L.run, jb = 4 * kw - rw * L.run;
    const uint32_t keep =
        kwc - jb >= 4 ? 0xffffffffu
                      : (kwc > jb ? (1u << (8 * (kwc - jb))) - 1 : 0u);
#pragma unroll 4
    for (int p = 16 * warp + (lane >> shift); p < 16 * warp + 16;
         p += 32 >> shift) {
      const int prb = (p / kCols) * s.stride, pcb = (p % kCols) * s.stride;
      const unsigned char* px = patch + pcb * pb;
      uint32_t word = 0;
      if (inside) {
        if (rw < s.KH) {
          const unsigned char* src = px + rows[prb + rw] + jb;
          const unsigned char* al = reinterpret_cast<const unsigned char*>(
              reinterpret_cast<uintptr_t>(src) & ~uintptr_t(3));
          word = __funnelshift_r(ld32(al), ld32(al + 4),
                                 8 * static_cast<int>(src - al)) &
                 keep;
        }
        *reinterpret_cast<uint32_t*>(A + p * L.a_stride + 4 * kw) = word;
        continue;
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if ((e & 1) && pair[e >> 1]) continue;   // loaded at e - 1
        if (r[e] == 0xffff ||
            static_cast<unsigned>(pcb + c[e]) >= pspan)
          continue;
        const int ro = rows[prb + r[e]];
        if (ro < 0) continue;
        const unsigned char* src = px + ro + off[e];
        const uint32_t v =
            pair[e >> 1] ? *reinterpret_cast<const uint16_t*>(src) : *src;
        word |= v << (8 * e);
      }
      *reinterpret_cast<uint32_t*>(A + p * L.a_stride + 4 * kw) = word;
    }
  }
}

// tf32 by rows: A value (pixel p of sub-tile t, K index kk) straight from
// the patch rows, 0 for padding and outside the image (`inside`: the
// sub-tile's whole patch lies in the image, so no check is needed)
__device__ __forceinline__ uint32_t a_value(const unsigned char* patch,
                                            const int* tab, const int* rows,
                                            const Shape& s, const Layout& L,
                                            const Tile& t, bool inside, int p,
                                            int kk) {
  const int rc = tab[kk], r = rc & 0xffff;
  if (r == 0xffff) return 0u;
  const int prb = (p / kCols) * s.stride, pcb = (p % kCols) * s.stride;
  const int ro = rows[prb + r];
  const int off = tab[L.Kp + kk];
  if (!inside) {
    const int wi = t.wo0 * s.stride - s.pad_left + pcb + (rc >> 16);
    if (ro < 0 || wi < 0 || wi >= s.W) return 0u;
  }
  return ld32(patch + ro + pcb * 4 * s.Cin + off);
}

// This lane's ldmatrix row of the A tile at K step `st` (32 bytes of K):
// pixel row `arow` = 16 warp + (lane & 7) + 8 ((lane >> 3) & 1) of the
// sub-tile, whose staged pixel is at `in_lane` in the patch, and 16-byte
// half `khalf` = lane >> 4 of the step (one table entry in place).
__device__ __forceinline__ const unsigned char* a_row(
    const unsigned char* patch, const unsigned char* A, const int* tab,
    const unsigned char* zero, const Layout& L, int in_lane, int arow,
    int khalf, int st) {
  if (!L.inplace) return A + arow * L.a_stride + 32 * st + 16 * khalf;
  const int o = tab[2 * st + khalf];
  return o >= 0 ? patch + in_lane + o : zero;
}

// How one pass's outputs are staged: a warp's 16 pixels (half a tile row,
// contiguous in the output) as one run when the pass holds every channel
// of a pixel (`rowseg`), else one run per pixel. Each warp stages and
// stores only its own pixels, so a __syncwarp orders the two.
struct OutPass {
  int co;       // first output channel of the pass
  int ncv;      // channels of the pass that exist
  int elt;      // output bytes per value
  int rowseg;
  int run;      // shared-memory bytes per staged run
  int per_run;  // 16-byte chunks a run can touch
  FastDiv by_run;
};

static_assert(sizeof(OutPass) == kPlanBytes, "OutPass size");

// The passes' plans are the same on every tile: built once per block into
// shared memory (layout region off_plans), read from there on each tile
__device__ __forceinline__ OutPass out_pass(int Cout, int co, int ncv,
                                            int nchunk, int elt) {
  OutPass o;
  o.co = co;
  o.ncv = ncv;
  o.elt = elt;
  o.rowseg = co == 0 && ncv == Cout;
  o.run = o.rowseg ? round_up(elt * 16 * nchunk, 16) + 16
                   : round_up(elt * nchunk, 16) + 16;
  // a run starts 16-byte aligned when every pixel does (and, for a
  // channel run, its first channel): then it needs no spare chunk
  const bool aligned = (Cout * elt) % 16 == 0 && (co * elt) % 16 == 0;
  o.per_run = ((o.rowseg ? 16 * Cout : ncv) * elt + 15) / 16 + !aligned;
  o.by_run.init(o.per_run);
  return o;
}

// Staging offset of pixel p's first channel of the pass, or -1 when the
// pixel lies past Ho or Wo (channel n of the pass is at + n * elt)
__device__ __forceinline__ int out_offset(const Shape& s, const Tile& t,
                                          int Cout, const OutPass& o, int p) {
  const int rr = p / kCols, cc = p - rr * kCols;
  const int ho = t.ho0 + rr, wo = t.wo0 + cc;
  if (ho >= s.Ho || wo >= s.Wo) return -1;
  if (o.rowseg) {
    const int c0 = cc & ~15;          // the warp's first column
    const unsigned u = ((static_cast<unsigned>(t.b) * s.Ho + ho) * s.Wo +
                        t.wo0 + c0) * Cout * o.elt;
    return (p / 16) * o.run + static_cast<int>(u & 15u) +
           (cc - c0) * Cout * o.elt;
  }
  const unsigned u = (((static_cast<unsigned>(t.b) * s.Ho + ho) * s.Wo +
                       wo) * Cout + o.co) * o.elt;
  return p * o.run + static_cast<int>(u & 15u);
}

// Write a warp's staged runs of the pass to `out`: aligned 16-byte chunks
// as one load and one store each, the ragged ends of a run byte by byte.
__device__ __forceinline__ void store_pass(unsigned char* out,
                                           const unsigned char* sm,
                                           const Shape& s, const Tile& t,
                                           int Cout, const OutPass& o,
                                           int warp, int lane) {
  const int nrun = o.rowseg ? 1 : 16;
#pragma unroll 4
  for (int i = lane; i < nrun * o.per_run; i += 32) {
    const int q = o.by_run(i), k = i - q * o.per_run;
    const int r = o.rowseg ? warp : 16 * warp + q;   // run index
    const int p = o.rowseg ? 16 * warp : r;          // its first pixel
    const int ho = t.ho0 + p / kCols, wo = t.wo0 + p % kCols;
    if (ho >= s.Ho || wo >= s.Wo) continue;
    const long long pix = (static_cast<long long>(t.b) * s.Ho + ho) * s.Wo +
                          wo;
    const long long gs = (pix * Cout + o.co) * o.elt;
    const int vcols = s.Wo - wo < 16 ? s.Wo - wo : 16;
    const long long len = o.rowseg ? static_cast<long long>(vcols) * Cout *
                                         o.elt
                                   : static_cast<long long>(o.ncv) * o.elt;
    const long long c = gs - (gs & 15) + 16LL * k;
    const long long end = gs + len;
    if (c >= end) continue;
    // the run is staged at r * run + (gs & 15): global c sits at
    // c - floor16(gs)
    const unsigned char* from = sm + r * o.run + (c - (gs - (gs & 15)));
    if (c >= gs && c + 16 <= end) {
      *reinterpret_cast<int4*>(out + c) =
          *reinterpret_cast<const int4*>(from);
    } else {
      for (int e = 0; e < 16; ++e)
        if (c + e >= gs && c + e < end) out[c + e] = from[e];
    }
  }
}

// Persistent blocks for the channel block on gridDim.y: as many as fit
// the SMs at once (at least one per channel block), never more than tiles.
// The kernel's shared-memory cap and its occupancy at a footprint are
// asked of the runtime once and kept (a few entries), so a launch costs
// the host no runtime query after the first.
template <typename Kernel>
inline int persistent_grid(Kernel kernel, int smem, int ncb,
                           long long ntiles, dim3* grid) {
  struct Entry {
    const void* fn;
    int dev, smem, blocks;     // blocks: per_sm * SMs
  };
  static Entry cache[16];
  static int filled = 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  const void* fn = reinterpret_cast<const void*>(kernel);
  int blocks = -1;
  for (int i = 0; i < filled; ++i)
    if (cache[i].fn == fn && cache[i].dev == dev && cache[i].smem == smem)
      blocks = cache[i].blocks;
  if (blocks < 0) {
    // the cap, not this footprint: a later, larger footprint of the same
    // kernel finds it set
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemLimit);
    int sms = 0, per_sm = 0;
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    blocks = (per_sm > 0 ? per_sm : 1) * sms;
    cache[filled % 16] = Entry{fn, dev, smem, blocks};
    if (filled < 16) ++filled;
  }
  long long bx = blocks / ncb;
  if (bx < 1) bx = 1;
  if (bx > ntiles) bx = ntiles;
  *grid = dim3(static_cast<unsigned>(bx), ncb, 1);
  return 0;
}

}  // namespace igemm
