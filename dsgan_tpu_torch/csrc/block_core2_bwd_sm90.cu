// Fused ConvNeXt block core, backward, bf16, on Hopper's tensor cores
// through wgmma, fed by TMA (sm_90a): the one-input form (K2) and the
// two-input form (K4).
//
// Replaces the TPU kernels of dsgan_tpu/pallas/block_core.py:
//   K2  _bwd_kernel  (:116-190) / _bwd_impl  (pallas_call at :262)
//   K4  _bwd_kernel2 (:431-530) / _bwd2_impl (pallas_call at :598)
// Given the forward's parts (h, x) = (h_a | h_b, x_a | x_b) (the one-input
// form: C2 = 0, part b's pointers null), their InstanceNorm statistics and
// the cotangent g of the output, per pixel row, with
//   a   = bf16((h - mean) * rsig)         the normalized input
//   h1  = a @ W1 + b1                     the hidden, f32, recomputed
//   ag  = bf16(gelu(h1)),  dg1 = (g @ W2^T) * gelu'(h1)
// it computes
//   dn  = bf16(dg1) @ W1^T  -> dna | dnb  dx = g @ Ws^T -> dxa | dxb
//   dW1 = a^T bf16(dg1)   db1 = sum dg1   dW2 = ag^T g   db2 = sum g
//   dWs = x^T g           S1 = sum_HW dn  S2 = sum_HW dn * (h - mean)
// with one tanh for gelu and gelu' (the exact pair in the erf flavour),
// every sum in f32, dn and dx rounded once, dW1 and dWs in the concat
// layout, S1/S2 per image and part. The caller folds dn, S1 and S2 into
// the InstanceNorm cotangent. The f32 check build of K4 stays in
// block_core_bwd.cu; this file holds the bf16 path alone.
//
// What bounds it: 2(12C^2 + 10CP) operations a row against 2(4C + P)
// bytes a row in and out, operations-bound at every decoder site: 0.591 ms
// at batch 16 at each of uc1-uc4 (C = 1024, 512, 256, 128; P = C / 2;
// 16,384 to 1,048,576 rows; 584 GFLOP at 989 TFLOP/s), and at c2-c5
// (0.070 ms each); c1 (C = 3, P = 64, a million rows) is bytes-bound
// (0.048 ms).
//
// Design: the backward as GEMM-shaped passes, none of whose tiles depends
// on C, each block two consumer warpgroups of 64 rows (wgmma m64, f32
// accumulators in registers, 232 registers through setmaxnreg) and one
// producer warp that streams both operands by TMA through a ring of
// 128-byte-swizzled stages guarded by full / empty mbarriers:
//
//   P  prep: a and x side by side (M x Cp, zero padding; TMA cannot
//      normalize), g padded to 16-byte rows where P % 8 != 0, and per
//      128-row tile the column sums of g (db2 partials);
//   R1 hidden pass, 128 rows x 128 hidden columns a block: h1 = a @ W1
//      (K = Cp) and da = g @ W2^T (K = Pp) into two accumulators; the
//      epilogue writes ag and bf16(dg1) to scratch and the tile's db1
//      column partials; more blocks of the same grid compute dx = g @ Ws^T
//      128 channels at a time;
//   R2 dn pass, 128 rows x 128 input channels: dn = bf16(dg1) @ W1^T
//      (K = H4p); the epilogue writes dna / dnb and the tile's S1 / S2
//      column partials (reading h for h - mean). Row tiles never cross an
//      image, so the S partials are per image;
//   W  weight pass: dW1 = a^T dg1, dW2 = ag^T g, dWs = x^T g as products
//      over the rows split into chunks, 128 x 128 output tiles, both
//      operands MN-major (TMA boxes of 64 rows x 64 columns, wgmma's
//      transpose bits), into f32 partials;
//   a fixed-order reduce of every partial buffer (two levels where a sum
//      has more than 64 terms).
//
// R1, R2 and W are persistent (one block a SM walks the work items). Every
// B operand of R1 and R2 is K-major: W1^T from the transposed pack, W2 and
// W1 as packed, so no tile is transposed on the card. No atomics: every
// sum is taken in one fixed order and runs repeat bit for bit.
//
// One input of C <= 4 channels (c1: C = 3, 4C = 12) takes a narrow row
// pass in place of P, R1 and R2: a 64-wide K step and a 128-wide hidden
// tile would be four to eight times padding there, and R1's epilogue is
// what bounds it. One thread a row computes the 16-wide hidden, da, dg1, dn
// and dx with FMAs against weights in shared memory (f32, read by
// broadcast), writes a, x, ag and dg1 to the scratch and dn, dx out, and
// the block (one 128-row tile of one image) sums its rows' db1, S1, S2 and
// db2 partials in a fixed order; the weight pass and the reduce follow as
// for every other shape.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace sm90;

constexpr int SMS = 132;         // the H100's SMs: the weight pass splits to fill them twice
constexpr int STAGES = 4;        // ring depth of every pass
constexpr int RED_CHUNK = 64;    // terms per first-level sum of the reduce
constexpr int THREADS = 384;     // two consumer warpgroups and the producer's
constexpr int NARROW_C = 4;      // the narrow row pass: one input of at most 4 channels,
constexpr int NARROW_H = 16;     // so one 16-wide hidden tile; one thread a row

struct Args {
  const bf16 *ha, *hb, *xa, *xb, *g;
  const float *mean_a, *rsig_a, *mean_b, *rsig_b;
  const bf16 *w1, *w1t, *b1, *w2, *ws;
  bf16 *dna, *dnb, *dxa, *dxb;
  float *dw1, *db1, *dw2, *db2, *dws, *s1a, *s2a, *s1b, *s2b;
  int B, HW, C1, C2, C1p, Cp, H4, H4p, P, Pp, vec;
};

// ------------------------------------------------------------------ plan

struct WJob {
  int R, N, bn, nsplit, rps;  // output rows and padded columns, tile width, row splits
  size_t off;                 // partials (R, nsplit, N) f32
};

struct Plan {
  int timg, tiles;  // 128-row tiles per image, in all
  int gcopy;        // g is padded into scratch (P % 8 != 0)
  int narrow;       // the narrow row pass (C2 = 0, C1 <= NARROW_C)
  size_t off_a, off_x, off_g, off_ag, off_dg, off_db1, off_db2, off_s1, off_s2, off_tmp, total;
  WJob jobs[3];  // dW1, dW2, dWs
};

size_t align256(size_t n) { return (n + 255) / 256 * 256; }

// floats the first level of a reduce of G groups of S terms over L columns keeps
size_t reduce_tmp(long long G, long long S, long long L) {
  return S > RED_CHUNK ? (size_t)(G * ((S + RED_CHUNK - 1) / RED_CHUNK) * L) : 0;
}

// kernels/block_core.py::k4_plan mirrors this.
Plan make_plan(const Args& a) {
  Plan pl{};
  const long long M = (long long)a.B * a.HW;
  pl.timg = (a.HW + 127) / 128;
  pl.tiles = a.B * pl.timg;
  pl.gcopy = a.P % 8 != 0;
  pl.narrow = a.C2 == 0 && a.C1 <= NARROW_C;  // kernels/block_core.py::narrow_route
  size_t off = 0;
  auto take = [&](size_t bytes) {
    const size_t at = off;
    off = align256(off + bytes);
    return at;
  };
  pl.off_a = take((size_t)M * a.Cp * 2);
  pl.off_x = take((size_t)M * a.Cp * 2);
  pl.off_g = take(pl.gcopy ? (size_t)M * a.Pp * 2 : 0);
  pl.off_ag = take((size_t)M * a.H4p * 2);
  pl.off_dg = take((size_t)M * a.H4p * 2);
  pl.off_db1 = take(sizeof(float) * pl.tiles * a.H4p);
  pl.off_db2 = take(sizeof(float) * pl.tiles * a.Pp);
  pl.off_s1 = take(sizeof(float) * pl.tiles * a.Cp);
  pl.off_s2 = take(sizeof(float) * pl.tiles * a.Cp);
  const int rn[3][2] = {{a.Cp, a.H4p}, {a.H4p, a.Pp}, {a.Cp, a.Pp}};
  size_t tmp = 0;
  for (int j = 0; j < 3; ++j) {
    WJob& jb = pl.jobs[j];
    jb.R = rn[j][0], jb.N = rn[j][1];
    jb.bn = jb.N > 64 ? 128 : 64;
    const long long tiles_out = (long long)((jb.R + 127) / 128) * ((jb.N + jb.bn - 1) / jb.bn);
    long long ns = (2 * SMS + tiles_out - 1) / tiles_out;
    const long long most = (M + 511) / 512;  // at least 512 rows a split
    ns = ns > most ? most : ns;
    ns = ns < 1 ? 1 : ns;
    jb.rps = (int)(((M + ns - 1) / ns + 63) / 64 * 64);
    jb.nsplit = (int)((M + jb.rps - 1) / jb.rps);
    jb.off = take(sizeof(float) * (size_t)jb.R * jb.nsplit * jb.N);
    const size_t t = reduce_tmp(jb.R, jb.nsplit, jb.N);
    tmp = t > tmp ? t : tmp;
  }
  const size_t sums[3] = {reduce_tmp(1, pl.tiles, a.H4p), reduce_tmp(1, pl.tiles, a.Pp),
                          reduce_tmp(a.B, pl.timg, a.Cp)};
  for (size_t t : sums) tmp = t > tmp ? t : tmp;
  pl.off_tmp = take(sizeof(float) * tmp);
  pl.total = off;
  return pl;
}

// ------------------------------------------------------------ device parts

__device__ __forceinline__ float gelu_parts(float v, float* dgelu, bool tanh_flavour) {
  if (tanh_flavour) {
    const float k0 = 0.7978845608028654f;  // sqrt(2 / pi)
    const float k1 = 0.044715f;
    // one tanh for the value and the derivative, as the TPU kernel
    const float th = tanhf(k0 * (v + k1 * v * v * v));
    *dgelu = 0.5f * (1.0f + th) + 0.5f * v * (1.0f - th * th) * (k0 * (1.0f + 3.0f * k1 * v * v));
    return 0.5f * v * (1.0f + th);
  }
  const float cdf = 0.5f * (1.0f + erff(v * 0.7071067811865476f));
  *dgelu = cdf + v * 0.3989422804014327f * expf(-0.5f * v * v);  // Phi + v phi
  return v * cdf;
}

// Consumers' side of the ring (see block_core2_fwd_sm90.cu).
struct Ring {
  unsigned char* base;
  uint64_t *full, *empty;
  int stage_bytes, stage = 0;
  uint32_t phase = 0;

  __device__ unsigned char* wait() {
    bar_wait(&full[stage], phase);
    return base + stage * stage_bytes;
  }
  __device__ void done() {
    mma_wait<0>();
    if (threadIdx.x % 32 == 0) bar_arrive(&empty[stage]);
    if (++stage == STAGES) stage = 0, phase ^= 1;
  }
};

// Producer's side: one thread fills stage after stage.
struct Feed {
  unsigned char* base;
  uint64_t *full, *empty;
  int stage_bytes, stage = 0;
  uint32_t phase = 0;

  __device__ unsigned char* next(uint32_t bytes) {
    bar_wait(&empty[stage], phase ^ 1);
    bar_expect_tx(&full[stage], bytes);
    return base + stage * stage_bytes;
  }
  __device__ uint64_t* bar() { return &full[stage]; }
  __device__ void advance() {
    if (++stage == STAGES) stage = 0, phase ^= 1;
  }
};

// The dynamic shared memory of a pass: the ring, then its barriers, then
// `extra` bytes; base aligned to 1024.
struct Smem {
  unsigned char* ring;
  uint64_t *full, *empty;
  unsigned char* extra;
};

__host__ __device__ constexpr int smem_bytes(int stage_bytes, int extra) {
  return 1024 + STAGES * stage_bytes + 2 * 8 * STAGES + extra;
}

template <int STAGE>
__device__ Smem setup() {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  Smem s{base, reinterpret_cast<uint64_t*>(base + STAGES * STAGE), nullptr, nullptr};
  s.empty = s.full + STAGES;
  s.extra = reinterpret_cast<unsigned char*>(s.empty + STAGES);
  if (threadIdx.x == 0) {
    for (int i = 0; i < STAGES; ++i) {
      bar_init(&s.full[i], 1);
      bar_init(&s.empty[i], 8);  // every consumer warp hands a stage back
    }
    bar_init_fence();
  }
  __syncthreads();
  return s;
}

// acc (+)= A @ B over `steps` stages of [A: 128 rows x 64, K-major | B:
// N rows x 64, K-major]; this warpgroup's rows of A at `a_off`.
template <int N>
__device__ void mma_steps(Ring& rg, float (&acc)[N / 2], int steps, int a_off) {
  hold(acc);
  for (int k = 0; k < steps; ++k) {
    unsigned char* st = rg.wait();
    mma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      mma_ss<N, 0, 0>(acc, desc_kmajor(st + a_off + 32 * kk), desc_kmajor(st + 16384 + 32 * kk),
                      k > 0 || kk > 0);
    mma_commit();
    rg.done();
  }
  hold(acc);
}

// Column sums over the block's 128 rows of the 128-column accumulator
// values `v` (masked by the caller), in one fixed order: the two rows a
// thread holds, the warp's 16 rows by shuffles, then the 8 warps in turn
// through `red` (8 x 128 floats). Writes out[c] for c < ncols. All 256
// consumer threads call it.
__device__ void column_sums(const float (&v)[64], float* red, float* out, int ncols) {
  const int t = threadIdx.x % 128, w8 = threadIdx.x / 32, lane = t % 32;
#pragma unroll
  for (int n8 = 0; n8 < 16; ++n8) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float s = v[4 * n8 + e] + v[4 * n8 + 2 + e];
      s += __shfl_xor_sync(0xffffffffu, s, 4);
      s += __shfl_xor_sync(0xffffffffu, s, 8);
      s += __shfl_xor_sync(0xffffffffu, s, 16);
      if (lane < 4) red[w8 * 128 + 8 * n8 + 2 * lane + e] = s;
    }
  }
  sync_threads(3, 256);
  if (threadIdx.x < 128 && (int)threadIdx.x < ncols) {
    float s = 0.0f;
#pragma unroll
    for (int w = 0; w < 8; ++w) s += red[w * 128 + threadIdx.x];
    out[threadIdx.x] = s;
  }
  sync_threads(3, 256);
}

// ------------------------------------------------------------------ prep

struct PrepArgs {
  Args a;
  bf16 *as, *xs, *gp;  // (M, Cp), (M, Cp), (M, Pp) or null
  float* part_db2;     // (tiles, Pp)
  int timg;
};

// Blocks (x, y): the 128-row tile x of one image, and the y-th of gridDim.y
// slices of its columns (more than one where there are few tiles): a and x
// side by side, g padded (if asked), the tile's column sums of g. Dynamic
// shared memory: 8 x Pp floats.
__global__ void __launch_bounds__(256) bc2_bwd_sm90_prep(const PrepArgs p) {
  extern __shared__ float prep_smem[];
  const Args& a = p.a;
  const int img = blockIdx.x / p.timg, t0 = blockIdx.x % p.timg * 128;
  const int nrows = min(128, a.HW - t0);
  const long long row0 = (long long)img * a.HW + t0;
  // this block's 8-wide chunks of a and x, and column pairs of g
  const int chunks = a.Cp / 8, pairs = a.Pp / 2, ys = gridDim.y;
  const int ch0 = blockIdx.y * ((chunks + ys - 1) / ys);
  const int nch = max(0, min(chunks - ch0, (chunks + ys - 1) / ys));
  const int n_lo = 2 * (blockIdx.y * ((pairs + ys - 1) / ys));
  const int n_hi = min(a.Pp, n_lo + 2 * ((pairs + ys - 1) / ys));
  for (int item = threadIdx.x; item < nrows * nch; item += 256) {
    const int r = item / nch, c0 = (ch0 + item % nch) * 8;
    const long long row = row0 + r;
    float hv[8], xv[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) hv[e] = 0.0f, xv[e] = 0.0f;
    if (a.vec) {
      const bf16 *h = nullptr, *x = nullptr;
      const float *mean = nullptr, *rsig = nullptr;
      if (c0 < a.C1) {
        h = a.ha + row * a.C1 + c0, x = a.xa + row * a.C1 + c0;
        mean = a.mean_a + (size_t)img * a.C1 + c0, rsig = a.rsig_a + (size_t)img * a.C1 + c0;
      } else if (c0 >= a.C1p && c0 < a.C1p + a.C2) {
        const int cb = c0 - a.C1p;
        h = a.hb + row * a.C2 + cb, x = a.xb + row * a.C2 + cb;
        mean = a.mean_b + (size_t)img * a.C2 + cb, rsig = a.rsig_b + (size_t)img * a.C2 + cb;
      }
      if (h) {
        const uint4 hr = *reinterpret_cast<const uint4*>(h);
        const uint4 xr = *reinterpret_cast<const uint4*>(x);
        const bf16* h8 = reinterpret_cast<const bf16*>(&hr);
        const bf16* x8 = reinterpret_cast<const bf16*>(&xr);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          hv[e] = (__bfloat162float(h8[e]) - mean[e]) * rsig[e];
          xv[e] = __bfloat162float(x8[e]);
        }
      }
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int c = c0 + e;
        if (c < a.C1) {
          const size_t s = (size_t)img * a.C1 + c;
          hv[e] = (__bfloat162float(a.ha[row * a.C1 + c]) - a.mean_a[s]) * a.rsig_a[s];
          xv[e] = __bfloat162float(a.xa[row * a.C1 + c]);
        } else if (c >= a.C1p && c < a.C1p + a.C2) {
          const int cb = c - a.C1p;
          const size_t s = (size_t)img * a.C2 + cb;
          hv[e] = (__bfloat162float(a.hb[row * a.C2 + cb]) - a.mean_b[s]) * a.rsig_b[s];
          xv[e] = __bfloat162float(a.xb[row * a.C2 + cb]);
        }
      }
    }
    uint4 ho, xo;
    ho.x = pack_bf16(hv[0], hv[1]), ho.y = pack_bf16(hv[2], hv[3]);
    ho.z = pack_bf16(hv[4], hv[5]), ho.w = pack_bf16(hv[6], hv[7]);
    xo.x = pack_bf16(xv[0], xv[1]), xo.y = pack_bf16(xv[2], xv[3]);
    xo.z = pack_bf16(xv[4], xv[5]), xo.w = pack_bf16(xv[6], xv[7]);
    *reinterpret_cast<uint4*>(p.as + row * a.Cp + c0) = ho;
    *reinterpret_cast<uint4*>(p.xs + row * a.Cp + c0) = xo;
  }
  // db2 partials: 8 groups of rows (r % 8) by column pairs, then the
  // groups in order; and g padded where asked
  float* red = reinterpret_cast<float*>(prep_smem);  // 8 x Pp
  const int grp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const bool even = a.P % 2 == 0;
  for (int n = n_lo + 2 * lane; n < n_hi; n += 64) {
    float s0 = 0.0f, s1 = 0.0f;
    for (int r = grp; r < nrows; r += 8) {
      const bf16* src = a.g + (row0 + r) * a.P + n;
      if (even && n < a.P) {
        const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(src);
        s0 += __low2float(v), s1 += __high2float(v);
      } else {
        if (n < a.P) s0 += __bfloat162float(src[0]);
        if (n + 1 < a.P) s1 += __bfloat162float(src[1]);
      }
    }
    red[grp * a.Pp + n] = s0;
    red[grp * a.Pp + n + 1] = s1;
  }
  __syncthreads();
  for (int n = n_lo + threadIdx.x; n < n_hi; n += 256) {
    float s = 0.0f;
#pragma unroll
    for (int k = 0; k < 8; ++k) s += red[k * a.Pp + n];
    p.part_db2[(size_t)blockIdx.x * a.Pp + n] = s;
  }
  if (p.gp) {
    const int w = n_hi - n_lo;
    for (int i = threadIdx.x; i < nrows * w; i += 256) {
      const int r = i / w, n = n_lo + i % w;
      p.gp[(row0 + r) * a.Pp + n] = n < a.P ? a.g[(row0 + r) * a.P + n] : __float2bfloat16_rn(0.0f);
    }
  }
}

// ------------------------------------------------------------- R1 and R2

// R1, R2 and the weight pass are persistent: one block on each SM walks
// the work items blockIdx.x, blockIdx.x + gridDim.x, ..., its producer
// running ahead into the next item while the consumers finish one.

struct RowArgs {
  Args a;
  bf16 *ag, *dg;            // (M, H4p) scratch
  float *part_db1, *part_s1, *part_s2;
  int timg, tiles, nj, nx;  // tiles a image, in all; hidden and channel chunks of 128
};

// A work item of R1 / R2: row tile `tile` (128 rows of one image) by the
// 128-wide column chunk `y`; tiles run in order, each over its chunks, so
// that the SMs at work share row tiles in L2.
struct RowItem {
  int tile, img, t0, row0, nrows, y;
  __device__ RowItem(const RowArgs& p, int w, int ny) {
    tile = w / ny, y = w % ny;
    img = tile / p.timg, t0 = tile % p.timg * 128;
    row0 = img * p.a.HW + t0;
    nrows = min(128, p.a.HW - t0);
  }
};

constexpr int ROW_STAGE = 32768;  // A 128 x 64 and B 128 x 64, bf16
constexpr int ROW_SMEM = smem_bytes(ROW_STAGE, 8 * 128 * 4);

// R1: chunks y < nj: the hidden chunk y; else the dx chunk y - nj.
template <bool TANH>
__global__ void __launch_bounds__(THREADS, 1)
    bc2_bwd_sm90_hidden(const __grid_constant__ CUtensorMap m_a,
                        const __grid_constant__ CUtensorMap m_g,
                        const __grid_constant__ CUtensorMap m_w1t,
                        const __grid_constant__ CUtensorMap m_w2,
                        const __grid_constant__ CUtensorMap m_ws, const RowArgs p) {
  const Args& a = p.a;
  Smem sm = setup<ROW_STAGE>();
  const int ny = p.nj + p.nx, items = p.tiles * ny;
  const int ckc = (a.Cp + 63) / 64, ckp = (a.Pp + 63) / 64;
  const int wg = threadIdx.x / 128;

  if (wg == 2) {
    regs_shrink<40>();
    if (threadIdx.x % 128 == 0) {
      Feed f{sm.ring, sm.full, sm.empty, ROW_STAGE};
      for (int w = blockIdx.x; w < items; w += gridDim.x) {
        const RowItem it(p, w, ny);
        auto load = [&](const CUtensorMap* ma, const CUtensorMap* mb, int k, int brow) {
          unsigned char* st = f.next(ROW_STAGE);
          tma_load(st, ma, f.bar(), 64 * k, it.row0);
          tma_load(st + 16384, mb, f.bar(), 64 * k, brow);
          f.advance();
        };
        if (it.y < p.nj) {
          for (int k = 0; k < ckc; ++k) load(&m_a, &m_w1t, k, it.y * 128);
          for (int k = 0; k < ckp; ++k) load(&m_g, &m_w2, k, it.y * 128);
        } else {
          for (int k = 0; k < ckp; ++k) load(&m_g, &m_ws, k, (it.y - p.nj) * 128);
        }
      }
    }
  } else {
    regs_grow<232>();
    Ring rg{sm.ring, sm.full, sm.empty, ROW_STAGE};
    float* red = reinterpret_cast<float*>(sm.extra);
    for (int w = blockIdx.x; w < items; w += gridDim.x) {
      const RowItem it(p, w, ny);
      if (it.y < p.nj) {
        const int col0 = it.y * 128;
        float h1[64], da[64];
        mma_steps<128>(rg, h1, ckc, wg * 8192);
        mma_steps<128>(rg, da, ckp, wg * 8192);
#pragma unroll
        for (int i = 0; i < 64; i += 2) {
          const int r = 64 * wg + acc_row(i), c = col0 + acc_col(i);
          const bool ok = r < it.nrows && c < a.H4p;
          float act[2] = {0.0f, 0.0f}, dg[2] = {0.0f, 0.0f};
          if (c < a.H4p) {
            const __nv_bfloat162 bb = *reinterpret_cast<const __nv_bfloat162*>(a.b1 + c);
            const float bias[2] = {__low2float(bb), __high2float(bb)};
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              float dgelu;
              act[e] = gelu_parts(h1[i + e] + bias[e], &dgelu, TANH);
              dg[e] = da[i + e] * dgelu;
            }
          }
          if (ok) {
            const size_t o = (size_t)(it.row0 + r) * a.H4p + c;
            *reinterpret_cast<uint32_t*>(p.ag + o) = pack_bf16(act[0], act[1]);
            *reinterpret_cast<uint32_t*>(p.dg + o) = pack_bf16(dg[0], dg[1]);
          }
          // db1 sums the f32 dg1 of this image's rows
          da[i] = ok ? dg[0] : 0.0f;
          da[i + 1] = ok ? dg[1] : 0.0f;
        }
        column_sums(da, red, p.part_db1 + (size_t)it.tile * a.H4p + col0, min(128, a.H4p - col0));
      } else {
        const int col0 = (it.y - p.nj) * 128;
        float dx[64];
        mma_steps<128>(rg, dx, ckp, wg * 8192);
        const bool pairs = a.C1 % 2 == 0 && a.C2 % 2 == 0;
#pragma unroll
        for (int i = 0; i < 64; i += 2) {
          const int r = 64 * wg + acc_row(i), c = col0 + acc_col(i);
          if (r >= it.nrows) continue;
          const long long row = it.row0 + r;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            if (pairs && e == 1) break;
            const int ce = c + e;
            bf16* dst = nullptr;
            if (ce < a.C1) dst = a.dxa + row * a.C1 + ce;
            else if (ce >= a.C1p && ce < a.C1p + a.C2) dst = a.dxb + row * a.C2 + (ce - a.C1p);
            if (!dst) continue;
            if (pairs) *reinterpret_cast<uint32_t*>(dst) = pack_bf16(dx[i], dx[i + 1]);
            else *dst = __float2bfloat16_rn(dx[i + e]);
          }
        }
      }
    }
  }
}

// R2: dn for 128 rows x 128 input channels, S1 / S2 partials.
__global__ void __launch_bounds__(THREADS, 1)
    bc2_bwd_sm90_dn(const __grid_constant__ CUtensorMap m_dg,
                    const __grid_constant__ CUtensorMap m_w1, const RowArgs p) {
  const Args& a = p.a;
  Smem sm = setup<ROW_STAGE>();
  const int items = p.tiles * p.nx;
  const int ckh = (a.H4p + 63) / 64;
  const int wg = threadIdx.x / 128;

  if (wg == 2) {
    regs_shrink<40>();
    if (threadIdx.x % 128 == 0) {
      Feed f{sm.ring, sm.full, sm.empty, ROW_STAGE};
      for (int w = blockIdx.x; w < items; w += gridDim.x) {
        const RowItem it(p, w, p.nx);
        for (int k = 0; k < ckh; ++k) {
          unsigned char* st = f.next(ROW_STAGE);
          tma_load(st, &m_dg, f.bar(), 64 * k, it.row0);
          tma_load(st + 16384, &m_w1, f.bar(), 64 * k, it.y * 128);
          f.advance();
        }
      }
    }
  } else {
    regs_grow<232>();
    Ring rg{sm.ring, sm.full, sm.empty, ROW_STAGE};
    float* red = reinterpret_cast<float*>(sm.extra);
    for (int w = blockIdx.x; w < items; w += gridDim.x) {
      const RowItem it(p, w, p.nx);
      const int col0 = it.y * 128;
      float dn[64];
      mma_steps<128>(rg, dn, ckh, wg * 8192);
      float hm[64];  // h - mean at each of this thread's elements, 0 where masked
#pragma unroll
      for (int i = 0; i < 64; i += 2) {
        const int r = 64 * wg + acc_row(i), c = col0 + acc_col(i);
        const long long row = it.row0 + r;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int ce = c + e;
          const bf16* h = nullptr;
          bf16* dst = nullptr;
          float mean = 0.0f;
          if (r < it.nrows && ce < a.C1) {
            h = a.ha + row * a.C1 + ce, dst = a.dna + row * a.C1 + ce;
            mean = a.mean_a[(size_t)it.img * a.C1 + ce];
          } else if (r < it.nrows && ce >= a.C1p && ce < a.C1p + a.C2) {
            const int cb = ce - a.C1p;
            h = a.hb + row * a.C2 + cb, dst = a.dnb + row * a.C2 + cb;
            mean = a.mean_b[(size_t)it.img * a.C2 + cb];
          }
          if (h) {
            *dst = __float2bfloat16_rn(dn[i + e]);
            hm[i + e] = __bfloat162float(*h) - mean;
          } else {
            hm[i + e] = 0.0f;
            dn[i + e] = 0.0f;
          }
        }
      }
      const int ncols = min(128, a.Cp - col0);
      column_sums(dn, red, p.part_s1 + (size_t)it.tile * a.Cp + col0, ncols);
#pragma unroll
      for (int i = 0; i < 64; ++i) hm[i] *= dn[i];
      column_sums(hm, red, p.part_s2 + (size_t)it.tile * a.Cp + col0, ncols);
    }
  }
}

// ------------------------------------------------------ narrow row pass

__host__ __device__ inline int narrow_smem_bytes(int pp) {
  return 4 * (NARROW_C * NARROW_H + NARROW_H + (NARROW_H + NARROW_C) * pp + 4 * pp + 4 * 32);
}

// In place of P, R1 and R2 where C2 = 0 and C1 <= NARROW_C: block b takes
// the 128-row tiles b, b + gridDim.x, ..., one thread a row.
template <bool TANH>
__global__ void __launch_bounds__(128) bc2_bwd_sm90_narrow(const PrepArgs p, const RowArgs r) {
  extern __shared__ __align__(16) float nsm[];
  const Args& a = p.a;
  float* w1 = nsm;                       // NARROW_C x 16
  float* b1 = w1 + NARROW_C * NARROW_H;  // 16
  float* w2 = b1 + NARROW_H;             // 16 x Pp
  float* ws = w2 + NARROW_H * a.Pp;      // NARROW_C x Pp
  float* red = ws + NARROW_C * a.Pp;     // 4 x Pp: db2 by row group
  float* wred = red + 4 * a.Pp;          // 4 warps x 32: db1, S1, S2
  for (int i = threadIdx.x; i < NARROW_C * NARROW_H; i += 128)
    w1[i] = i / NARROW_H < a.C1 ? __bfloat162float(a.w1[i]) : 0.0f;
  for (int i = threadIdx.x; i < NARROW_H; i += 128) b1[i] = __bfloat162float(a.b1[i]);
  for (int i = threadIdx.x; i < (NARROW_H + NARROW_C) * a.Pp; i += 128) {
    const int row = i / a.Pp;
    w2[i] = row < NARROW_H ? __bfloat162float(a.w2[i])
            : row - NARROW_H < a.C1 ? __bfloat162float(a.ws[i - NARROW_H * a.Pp]) : 0.0f;
  }
  __syncthreads();

  const int t = threadIdx.x, lane = t % 32, warp = t / 32;
  const bool vec_g = a.P % 8 == 0;
  for (int tile = blockIdx.x; tile < r.tiles; tile += gridDim.x) {
    const int img = tile / r.timg, t0 = tile % r.timg * 128;
    const int nrows = min(128, a.HW - t0);
    const long long row = (long long)img * a.HW + t0 + t;
    const bool ok = t < nrows;
    float av[NARROW_C], hm[NARROW_C], xv[NARROW_C];
#pragma unroll
    for (int c = 0; c < NARROW_C; ++c) {
      av[c] = 0.0f, hm[c] = 0.0f, xv[c] = 0.0f;
      if (ok && c < a.C1) {
        const size_t s = (size_t)img * a.C1 + c;
        hm[c] = __bfloat162float(a.ha[row * a.C1 + c]) - a.mean_a[s];
        av[c] = __bfloat162float(__float2bfloat16_rn(hm[c] * a.rsig_a[s]));
        xv[c] = __bfloat162float(a.xa[row * a.C1 + c]);
      }
    }
    // the hidden, recomputed in f32; ag and gelu'
    float ag[NARROW_H], dgelu[NARROW_H];
#pragma unroll
    for (int j = 0; j < NARROW_H; ++j) {
      float v = 0.0f;
#pragma unroll
      for (int c = 0; c < NARROW_C; ++c) v = fmaf(av[c], w1[c * NARROW_H + j], v);
      ag[j] = gelu_parts(v + b1[j], &dgelu[j], TANH);
    }
    // da = g @ W2^T and dx = g @ Ws^T, 8 columns of g at a time; g padded
    // into the scratch where the weight pass cannot read it as it is
    float da[NARROW_H], dx[NARROW_C];
#pragma unroll
    for (int j = 0; j < NARROW_H; ++j) da[j] = 0.0f;
#pragma unroll
    for (int c = 0; c < NARROW_C; ++c) dx[c] = 0.0f;
    for (int n0 = 0; n0 < a.Pp; n0 += 8) {
      float gv[8];
      const bf16* src = a.g + row * a.P + n0;
      if (ok && vec_g && n0 < a.P) {
        const uint4 raw = *reinterpret_cast<const uint4*>(src);
        const bf16* g8 = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
        for (int e = 0; e < 8; ++e) gv[e] = __bfloat162float(g8[e]);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) gv[e] = ok && n0 + e < a.P ? __bfloat162float(src[e]) : 0.0f;
      }
      if (p.gp && ok) {
        uint4 o;
        o.x = pack_bf16(gv[0], gv[1]), o.y = pack_bf16(gv[2], gv[3]);
        o.z = pack_bf16(gv[4], gv[5]), o.w = pack_bf16(gv[6], gv[7]);
        *reinterpret_cast<uint4*>(p.gp + row * a.Pp + n0) = o;
      }
      auto dot8 = [&](const float* wrow) {
        const float4 lo = *reinterpret_cast<const float4*>(wrow + n0);
        const float4 hi = *reinterpret_cast<const float4*>(wrow + n0 + 4);
        return gv[0] * lo.x + gv[1] * lo.y + gv[2] * lo.z + gv[3] * lo.w + gv[4] * hi.x +
               gv[5] * hi.y + gv[6] * hi.z + gv[7] * hi.w;
      };
#pragma unroll
      for (int j = 0; j < NARROW_H; ++j) da[j] += dot8(w2 + j * a.Pp);
#pragma unroll
      for (int c = 0; c < NARROW_C; ++c) dx[c] += dot8(ws + c * a.Pp);
    }
    // dg1 (f32 for db1, bf16 for the products), dn = bf16(dg1) @ W1^T
    float dg1[NARROW_H], dn[NARROW_C];
#pragma unroll
    for (int c = 0; c < NARROW_C; ++c) dn[c] = 0.0f;
#pragma unroll
    for (int j = 0; j < NARROW_H; ++j) {
      dg1[j] = ok ? da[j] * dgelu[j] : 0.0f;
      const float dgt = __bfloat162float(__float2bfloat16_rn(dg1[j]));
#pragma unroll
      for (int c = 0; c < NARROW_C; ++c) dn[c] = fmaf(dgt, w1[c * NARROW_H + j], dn[c]);
    }
    if (ok) {
#pragma unroll
      for (int c = 0; c < NARROW_C; ++c) {
        if (c < a.C1) {
          a.dna[row * a.C1 + c] = __float2bfloat16_rn(dn[c]);
          a.dxa[row * a.C1 + c] = __float2bfloat16_rn(dx[c]);
        }
      }
      // the scratch rows the weight pass reads: a, x (Cp = 16), ag, dg1 (H4p = 16)
      auto put16 = [&](bf16* dst, const float* v, int n) {
        uint32_t w[8];
#pragma unroll
        for (int e = 0; e < 8; ++e)
          w[e] = pack_bf16(2 * e < n ? v[2 * e] : 0.0f, 2 * e + 1 < n ? v[2 * e + 1] : 0.0f);
        uint4* d = reinterpret_cast<uint4*>(dst + row * 16);
        d[0] = make_uint4(w[0], w[1], w[2], w[3]);
        d[1] = make_uint4(w[4], w[5], w[6], w[7]);
      };
      put16(p.as, av, NARROW_C);
      put16(p.xs, xv, NARROW_C);
      put16(r.ag, ag, NARROW_H);
      put16(r.dg, dg1, NARROW_H);
    }
    // db1, S1, S2 over the tile's rows: the warp by shuffles, the four
    // warps in turn
    float v[32];
#pragma unroll
    for (int j = 0; j < NARROW_H; ++j) v[j] = dg1[j];
#pragma unroll
    for (int c = 0; c < NARROW_C; ++c) {
      const bool real = ok && c < a.C1;
      v[NARROW_H + c] = real ? dn[c] : 0.0f;
      v[NARROW_H + NARROW_C + c] = real ? dn[c] * hm[c] : 0.0f;
    }
#pragma unroll
    for (int k = 0; k < NARROW_H + 2 * NARROW_C; ++k) {
#pragma unroll
      for (int o = 16; o > 0; o /= 2) v[k] += __shfl_xor_sync(0xffffffffu, v[k], o);
    }
    if (lane == 0) {
#pragma unroll
      for (int k = 0; k < NARROW_H + 2 * NARROW_C; ++k) wred[warp * 32 + k] = v[k];
    }
    // db2: 4 groups of rows (r % 4) by column pairs, then the groups in order
    for (int n = 2 * lane; n < a.Pp; n += 64) {
      float s0 = 0.0f, s1 = 0.0f;
      for (int rr = warp; rr < nrows; rr += 4) {
        const bf16* src = a.g + ((long long)img * a.HW + t0 + rr) * a.P + n;
        if (n < a.P) s0 += __bfloat162float(src[0]);
        if (n + 1 < a.P) s1 += __bfloat162float(src[1]);
      }
      red[warp * a.Pp + n] = s0;
      red[warp * a.Pp + n + 1] = s1;
    }
    __syncthreads();
    if (t < NARROW_H + 2 * NARROW_C) {
      const float s = wred[t] + wred[32 + t] + wred[64 + t] + wred[96 + t];
      if (t < NARROW_H) r.part_db1[(size_t)tile * NARROW_H + t] = s;
      else if (t < NARROW_H + NARROW_C) r.part_s1[(size_t)tile * a.Cp + (t - NARROW_H)] = s;
      else r.part_s2[(size_t)tile * a.Cp + (t - NARROW_H - NARROW_C)] = s;
    }
    for (int n = t; n < a.Pp; n += 128)
      p.part_db2[(size_t)tile * a.Pp + n] = red[n] + red[a.Pp + n] + red[2 * a.Pp + n] +
                                            red[3 * a.Pp + n];
    __syncthreads();
  }
}

// ---------------------------------------------------------- weight pass

struct WArgs {
  float* part;  // (R, nsplit, N)
  int M, R, N, nsplit, rps;
};

// part[r, split, n] = sum over the split's rows m of A[m, r] * B[m, n] for
// 128 x BN tiles of (r, n); A (M, R) and B (M, N) read MN-major in boxes
// of 64 rows x 64 columns. Work items run split by split, so that the SMs
// at work share rows of A and B in L2.
template <int BN>
__global__ void __launch_bounds__(THREADS, 1)
    bc2_bwd_sm90_weights(const __grid_constant__ CUtensorMap m_a,
                         const __grid_constant__ CUtensorMap m_b, const WArgs w) {
  constexpr int STAGE = 16384 + BN * 128;
  Smem sm = setup<STAGE>();
  const int tiles_n = (w.N + BN - 1) / BN;
  const int tiles = (w.R + 127) / 128 * tiles_n;
  const int items = tiles * w.nsplit;
  const int wg = threadIdx.x / 128;
  struct Item {
    int split, r0, n0, m_begin, steps;
  };
  auto item = [&](int i) {
    Item it;
    it.split = i / tiles;
    it.r0 = i % tiles / tiles_n * 128, it.n0 = i % tiles % tiles_n * BN;
    it.m_begin = it.split * w.rps;
    it.steps = (min(w.M, it.m_begin + w.rps) - it.m_begin + 63) / 64;
    return it;
  };

  if (wg == 2) {
    regs_shrink<40>();
    if (threadIdx.x % 128 == 0) {
      Feed f{sm.ring, sm.full, sm.empty, STAGE};
      for (int i = blockIdx.x; i < items; i += gridDim.x) {
        const Item it = item(i);
        for (int k = 0; k < it.steps; ++k) {
          const int m = it.m_begin + 64 * k;
          unsigned char* st = f.next(STAGE);
          tma_load(st, &m_a, f.bar(), it.r0, m);
          tma_load(st + 8192, &m_a, f.bar(), it.r0 + 64, m);
#pragma unroll
          for (int h = 0; h < BN / 64; ++h)
            tma_load(st + 16384 + 8192 * h, &m_b, f.bar(), it.n0 + 64 * h, m);
          f.advance();
        }
      }
    }
  } else {
    regs_grow<232>();
    Ring rg{sm.ring, sm.full, sm.empty, STAGE};
    for (int i = blockIdx.x; i < items; i += gridDim.x) {
      const Item it = item(i);
      float acc[BN / 2];
#pragma unroll
      for (int j = 0; j < BN / 2; ++j) acc[j] = 0.0f;
      hold(acc);
      for (int k = 0; k < it.steps; ++k) {
        unsigned char* st = rg.wait();
        mma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          mma_ss<BN, 1, 1>(acc, desc_mnmajor(st + 8192 * wg + 2048 * kk),
                           desc_mnmajor(st + 16384 + 2048 * kk), 1);
        mma_commit();
        rg.done();
      }
      hold(acc);
#pragma unroll
      for (int j = 0; j < BN / 2; j += 2) {
        const int r = it.r0 + 64 * wg + acc_row(j), n = it.n0 + acc_col(j);
        if (r < w.R && n < w.N)
          *reinterpret_cast<float2*>(w.part + ((size_t)r * w.nsplit + it.split) * w.N + n) =
              make_float2(acc[j], acc[j + 1]);
      }
    }
  }
}

// ----------------------------------------------------------------- reduce

// out[y * out_ld + i] = the sum over k in chunk c of in[(g * S + k) * in_ld + off + i],
// in order, for y = g * nch + c, nch = ceil(S / chunk).
__global__ void bc2_bwd_sm90_reduce(const float* in, int S, int chunk, int in_ld, int off, int L,
                                    float* out, int out_ld) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= L) return;
  const int nch = (S + chunk - 1) / chunk;
  const int g = blockIdx.y / nch, c = blockIdx.y % nch;
  const int k1 = min(S, (c + 1) * chunk);
  const float* p = in + (size_t)g * S * in_ld + off + i;
  float s = 0.0f;
  for (int k = c * chunk; k < k1; ++k) s += p[(size_t)k * in_ld];
  out[(size_t)blockIdx.y * out_ld + i] = s;
}

// out (G x L, out_ld) = the fixed-order sum of G groups of S rows of `in`;
// over RED_CHUNK terms in two levels through `tmp`.
int reduce(const float* in, int S, int in_ld, int off, int G, int L, float* out, int out_ld,
           float* tmp, cudaStream_t s) {
  if (G == 0 || L == 0) return 0;
  if (S > RED_CHUNK) {
    const int nch = (S + RED_CHUNK - 1) / RED_CHUNK;
    bc2_bwd_sm90_reduce<<<dim3((L + 255) / 256, G * nch), 256, 0, s>>>(in, S, RED_CHUNK, in_ld,
                                                                        off, L, tmp, L);
    if (cudaError_t e = cudaGetLastError()) return (int)e;
    in = tmp, S = nch, in_ld = L, off = 0;
  }
  bc2_bwd_sm90_reduce<<<dim3((L + 255) / 256, G), 256, 0, s>>>(in, S, S, in_ld, off, L, out,
                                                               out_ld);
  return (int)cudaGetLastError();
}

// ----------------------------------------------------------------- driver

template <typename K>
int allow_smem(K kernel, int bytes) {
  return sm90::allow_smem(reinterpret_cast<const void*>(kernel), bytes);
}

int run(int tanh_gelu, const Args& a, unsigned char* ws, cudaStream_t s) {
  const Plan pl = make_plan(a);
  const long long M = (long long)a.B * a.HW;
  bf16* as = reinterpret_cast<bf16*>(ws + pl.off_a);
  bf16* xs = reinterpret_cast<bf16*>(ws + pl.off_x);
  bf16* gp = pl.gcopy ? reinterpret_cast<bf16*>(ws + pl.off_g) : nullptr;
  bf16* ag = reinterpret_cast<bf16*>(ws + pl.off_ag);
  bf16* dg = reinterpret_cast<bf16*>(ws + pl.off_dg);
  float* part_db1 = reinterpret_cast<float*>(ws + pl.off_db1);
  float* part_db2 = reinterpret_cast<float*>(ws + pl.off_db2);
  float* part_s1 = reinterpret_cast<float*>(ws + pl.off_s1);
  float* part_s2 = reinterpret_cast<float*>(ws + pl.off_s2);
  float* tmp = reinterpret_cast<float*>(ws + pl.off_tmp);
  const bf16* g = gp ? gp : a.g;
  const int gld = gp ? a.Pp : a.P;
  int e = 0;

  // the tensor maps: row tiles of 128 for R1 / R2, 64 x 64 boxes for W
  CUtensorMap a128, g128, dg128, w1t, w2, wsm, w1, a64, x64, g64, ag64, dg64;
  if (!e) e = tensor_map(&a128, as, M, a.Cp, a.Cp, 64, 128);
  if (!e) e = tensor_map(&g128, g, M, gld, gld, 64, 128);
  if (!e) e = tensor_map(&dg128, dg, M, a.H4p, a.H4p, 64, 128);
  if (!e) e = tensor_map(&w1t, a.w1t, a.H4p, a.Cp, a.Cp, 64, 128);
  if (!e) e = tensor_map(&w2, a.w2, a.H4p, a.Pp, a.Pp, 64, 128);
  if (!e) e = tensor_map(&wsm, a.ws, a.Cp, a.Pp, a.Pp, 64, 128);
  if (!e) e = tensor_map(&w1, a.w1, a.Cp, a.H4p, a.H4p, 64, 128);
  if (!e) e = tensor_map(&a64, as, M, a.Cp, a.Cp, 64, 64);
  if (!e) e = tensor_map(&x64, xs, M, a.Cp, a.Cp, 64, 64);
  if (!e) e = tensor_map(&g64, g, M, gld, gld, 64, 64);
  if (!e) e = tensor_map(&ag64, ag, M, a.H4p, a.H4p, 64, 64);
  if (!e) e = tensor_map(&dg64, dg, M, a.H4p, a.H4p, 64, 64);
  if (e) return e;

  // persistent grids: one block on each SM (or one per item where fewer)
  int sms = 0;
  if ((e = sm_count(&sms))) return e;
  auto grid = [&](long long items) { return (unsigned)(items < sms ? items : sms); };

  PrepArgs pa{a, as, xs, gp, part_db2, pl.timg};
  const int nj = (a.H4p + 127) / 128, nx = (a.Cp + 127) / 128;
  RowArgs ra{a, ag, dg, part_db1, part_s1, part_s2, pl.timg, pl.tiles, nj, nx};
  if (pl.narrow) {
    auto narrow = tanh_gelu ? bc2_bwd_sm90_narrow<true> : bc2_bwd_sm90_narrow<false>;
    const int smem = narrow_smem_bytes(a.Pp);
    if ((e = allow_smem(narrow, smem))) return e;
    const long long most = 16LL * sms;  // 128-thread blocks, many a SM
    narrow<<<(unsigned)(pl.tiles < most ? pl.tiles : most), 128, smem, s>>>(pa, ra);
    if ((e = (int)cudaGetLastError())) return e;
  } else {
    if ((e = allow_smem(bc2_bwd_sm90_prep, 8 * 4 * a.Pp))) return e;
    // column slices where the tiles alone would not give every SM two blocks
    const int ys = (int)(2LL * sms < pl.tiles ? 1 : min(8LL, (2LL * sms + pl.tiles - 1) / pl.tiles));
    bc2_bwd_sm90_prep<<<dim3(pl.tiles, ys), 256, 8 * 4 * a.Pp, s>>>(pa);
    if ((e = (int)cudaGetLastError())) return e;
    auto hidden = tanh_gelu ? bc2_bwd_sm90_hidden<true> : bc2_bwd_sm90_hidden<false>;
    if ((e = allow_smem(hidden, ROW_SMEM))) return e;
    hidden<<<grid((long long)pl.tiles * (nj + nx)), THREADS, ROW_SMEM, s>>>(a128, g128, w1t, w2,
                                                                           wsm, ra);
    if ((e = (int)cudaGetLastError())) return e;
    if ((e = allow_smem(bc2_bwd_sm90_dn, ROW_SMEM))) return e;
    bc2_bwd_sm90_dn<<<grid((long long)pl.tiles * nx), THREADS, ROW_SMEM, s>>>(dg128, w1, ra);
    if ((e = (int)cudaGetLastError())) return e;
  }

  const CUtensorMap* srcs[3][2] = {{&a64, &dg64}, {&ag64, &g64}, {&x64, &g64}};
  for (int j = 0; j < 3; ++j) {
    const WJob& jb = pl.jobs[j];
    WArgs wa{reinterpret_cast<float*>(ws + jb.off), (int)M, jb.R, jb.N, jb.nsplit, jb.rps};
    const unsigned blocks = grid((long long)((jb.R + 127) / 128) * ((jb.N + jb.bn - 1) / jb.bn) *
                            jb.nsplit);
    if (jb.bn == 128) {
      constexpr int smem = smem_bytes(16384 + 128 * 128, 0);
      if ((e = allow_smem(bc2_bwd_sm90_weights<128>, smem))) return e;
      bc2_bwd_sm90_weights<128><<<blocks, THREADS, smem, s>>>(*srcs[j][0], *srcs[j][1], wa);
    } else {
      constexpr int smem = smem_bytes(16384 + 64 * 128, 0);
      if ((e = allow_smem(bc2_bwd_sm90_weights<64>, smem))) return e;
      bc2_bwd_sm90_weights<64><<<blocks, THREADS, smem, s>>>(*srcs[j][0], *srcs[j][1], wa);
    }
    if ((e = (int)cudaGetLastError())) return e;
  }

  // the weight gradients; dW1 and dWs part by part into the concat rows
  const WJob &j1 = pl.jobs[0], &j2 = pl.jobs[1], &j3 = pl.jobs[2];
  const float* p1 = reinterpret_cast<const float*>(ws + j1.off);
  const float* p2 = reinterpret_cast<const float*>(ws + j2.off);
  const float* p3 = reinterpret_cast<const float*>(ws + j3.off);
  // part b's rows of the partials start at row C1p, its output rows at C1
  const float* p1b = p1 + (size_t)a.C1p * j1.nsplit * j1.N;
  const float* p3b = p3 + (size_t)a.C1p * j3.nsplit * j3.N;
  float* dw1b = a.dw1 + (size_t)a.C1 * a.H4;
  float* dwsb = a.dws + (size_t)a.C1 * a.P;
  if (!e) e = reduce(p1, j1.nsplit, j1.N, 0, a.C1, a.H4, a.dw1, a.H4, tmp, s);
  if (!e) e = reduce(p1b, j1.nsplit, j1.N, 0, a.C2, a.H4, dw1b, a.H4, tmp, s);
  if (!e) e = reduce(p2, j2.nsplit, j2.N, 0, a.H4, a.P, a.dw2, a.P, tmp, s);
  if (!e) e = reduce(p3, j3.nsplit, j3.N, 0, a.C1, a.P, a.dws, a.P, tmp, s);
  if (!e) e = reduce(p3b, j3.nsplit, j3.N, 0, a.C2, a.P, dwsb, a.P, tmp, s);
  // db1, db2 over every tile; S1, S2 per image over its tiles
  if (!e) e = reduce(part_db1, pl.tiles, a.H4p, 0, 1, a.H4, a.db1, a.H4, tmp, s);
  if (!e) e = reduce(part_db2, pl.tiles, a.Pp, 0, 1, a.P, a.db2, a.P, tmp, s);
  if (!e) e = reduce(part_s1, pl.timg, a.Cp, 0, a.B, a.C1, a.s1a, a.C1, tmp, s);
  if (!e) e = reduce(part_s2, pl.timg, a.Cp, 0, a.B, a.C1, a.s2a, a.C1, tmp, s);
  if (!e) e = reduce(part_s1, pl.timg, a.Cp, a.C1p, a.B, a.C2, a.s1b, a.C2, tmp, s);
  if (!e) e = reduce(part_s2, pl.timg, a.Cp, a.C1p, a.B, a.C2, a.s2b, a.C2, tmp, s);
  return e;
}

}  // namespace

extern "C" {

// K4, bf16. Activations as (M, C1) / (M, C2) / (M, P) rows; mean, rsig
// (B, C) f32; the packed weights w1 (Cp, H4p), its transpose w1t (H4p,
// Cp), b1 (H4p), w2 (H4p, Pp), ws (Cp, Pp). Outputs: dna, dnb, dxa, dxb
// bf16 rows; dw1 (C1 + C2, H4), db1 (H4), dw2 (H4, P), db2 (P), dws
// (C1 + C2, P), s1a, s2a (B, C1), s1b, s2b (B, C2), all f32. vec: 16-byte
// loads of the parts. With workspace null it only writes the workspace's
// size in bytes to *workspace_bytes; otherwise it launches every pass on
// the stream and returns the first error (a cudaError_t, or
// sm90::ERR_TENSOR_MAP), or 0.
int block_core2_bwd_sm90(int tanh_gelu, const void* ha, const void* hb, const void* xa,
                         const void* xb, const void* g, const float* mean_a, const float* rsig_a,
                         const float* mean_b, const float* rsig_b, const void* w1, const void* w1t,
                         const void* b1, const void* w2, const void* ws, void* dna, void* dnb,
                         void* dxa, void* dxb, float* dw1, float* db1, float* dw2, float* db2,
                         float* dws, float* s1a, float* s2a, float* s1b, float* s2b, int B, int HW,
                         int C1, int C2, int C1p, int Cp, int H4, int H4p, int P, int Pp, int vec,
                         void* workspace, unsigned long long* workspace_bytes, void* stream) {
  auto bp = [](const void* p) { return static_cast<const bf16*>(p); };
  auto mp = [](void* p) { return static_cast<bf16*>(p); };
  Args a{bp(ha), bp(hb), bp(xa), bp(xb), bp(g), mean_a, rsig_a, mean_b, rsig_b,
         bp(w1), bp(w1t), bp(b1), bp(w2), bp(ws), mp(dna), mp(dnb), mp(dxa), mp(dxb),
         dw1, db1, dw2, db2, dws, s1a, s2a, s1b, s2b,
         B, HW, C1, C2, C1p, Cp, H4, H4p, P, Pp, vec};
  if (workspace == nullptr) {
    *workspace_bytes = make_plan(a).total;
    return 0;
  }
  return run(tanh_gelu, a, static_cast<unsigned char*>(workspace),
             static_cast<cudaStream_t>(stream));
}

}  // extern "C"
