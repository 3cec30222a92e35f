// Fused ConvNeXt block core, forward, bf16, for Hopper (sm_90a): the
// one-input form (K1) and the two-input form (K3).
//
// Replaces the TPU kernels of dsgan_tpu/pallas/block_core.py:
//   K1  _fwd_kernel  (:95-113)  / _fwd_impl  (pallas_call at :205)
//   K3  _fwd_kernel2 (:410-428) / _fwd2_impl (pallas_call at :553)
// Per pixel row r of the input's channel parts a (C1 channels) and b (C2;
// the one-input form is C2 = 0 with null part-b pointers), NHWC flattened
// to (M, C1) and (M, C2), it computes
//
//   out[r] = bf16( gelu(bf16([a_a | a_b][r]) @ [W1a; W1b] + b1) @ W2 + b2
//                  + [x_a | x_b][r] @ [Wsa; Wsb] ),   a = (h - mean) * rsig
//
// with the tanh GELU on the bf16-rounded hidden (or the exact one on the
// f32 hidden), the activated hidden rounded to bf16, every sum in f32 and
// one final rounding. The f32 check builds of K1 and K3 stay in
// block_core.cu; this file holds the bf16 paths alone.
//
// What bounds it: 2(4C^2 + 4CP + CP) operations a row against 2(2C + P)
// bytes a row. At batch 16 the decoder's sites (uc1-uc4) and the
// encoder's c3-c5 are operations-bound (0.226 ms at each uc site, 0.030 ms
// at each of c3-c5), c2 (C = 64, P = 128) and c1 (C = 3, P = 64) are
// bytes-bound (0.040 and 0.044 ms). The weights are what a row tile reads
// most: every block reads all of W1, W2 and Ws, so the rows a block owns
// set the L2 -> SM traffic.
//
// Three routes; kernels/block_core.py::fwd_plan picks one by shape:
//
// fused (P <= 256: c2, c3, uc2-uc4). A block owns 128 rows (64 where
// shared memory or the card's 132 SMs ask for it) and PN <= 256
// output columns: two consumer warpgroups of 64 rows each and one producer
// warp. The producer streams every weight tile the block needs, in the
// order the consumers use them, through a ring of S stages in
// 128-byte-swizzled shared memory: TMA boxes of Ws^T, then per hidden
// chunk of HC columns the W1^T tiles and the W2^T tiles (the wrapper packs
// the weights transposed, so every B operand is K-major), each stage
// guarded by a full and an empty mbarrier. The consumers normalize their
// rows into a resident swizzled A tile (16-byte loads where each part's
// width is a multiple of 8, element by element otherwise; TMA cannot
// normalize), first x for the shortcut, then (h - mean) * rsig. Per hidden
// chunk, GEMM1 (m64 x HC, K = Cp) runs into registers, bias and GELU run in
// registers, and the bf16 result is handed to GEMM2 as wgmma's register A
// operand (the accumulator layout is the A fragment layout), so the hidden
// never leaves the registers. The output accumulator (64 x PN f32, 128
// registers at PN = 256) stays in registers throughout; consumers take 232
// registers through setmaxnreg. Blocks are persistent: one a SM walks the
// (row tile, column block) items, its producer running ahead into the
// next item. Where P > 256 and a part's width rules out the two-pass route
// (not a multiple of 8), the output columns split over blocks, each
// recomputing GEMM1 (+61% operations at uc1's shape, +29% at c4's, +86%
// at c5's).
//
// two_pass (P > 256: c4, c5, uc1; measured faster than the column split
// at each, PERF.md). Pass 1 is the fused kernel's front half: per (row
// tile, slice of hidden chunks) item, GEMM1, bias and GELU, the bf16
// hidden stored to an (M, H4p) scratch
// (16 MB at c5, 32 MB at c4, batch 16: it stays in the 50 MB L2). Pass 2
// is one GEMM, out = [hid | x_a | x_b] @ [W2; Wsa; Wsb] + b2, both
// operands by TMA (K-major), 128 rows x BN <= 256 columns a block, the
// accumulator in registers. GEMM1 runs once per row, whatever P.
//
// narrow (one input of C <= 4: c1, C = 3, 4C = 12). Tensor cores buy
// nothing at K = 3, and a 64-wide wgmma K step or 128-wide hidden chunk
// is four to eight times padding (the fused route at c1 is measured
// beside this one in PERF.md): the site is bytes-bound (140 bytes a row
// over a million rows at batch 16). So it is an FMA kernel shaped for
// bandwidth: one thread a row, the whole 16-wide hidden in registers, the
// weights in shared memory as f32 read by broadcast, the output staged in
// shared memory and stored by the block as coalesced 16-byte stores.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace sm90;

constexpr int OUT_STAGES = 4;  // ring depth of the two-pass route's pass 2
constexpr int NARROW_C = 4;    // the narrow route: at most 4 input channels,
constexpr int NARROW_H = 16;   // so one 16-wide hidden tile
constexpr int NARROW_THREADS = 128;

struct Args {
  const bf16 *ha, *hb, *xa, *xb;
  const float *mean_a, *rsig_a, *mean_b, *rsig_b;
  const bf16 *b1, *b2;
  bf16* out;    // (M, P) rows; in the hidden pass the (M, H4p) scratch
  long long M;  // rows: batch * HW
  int HW, C1, C2, C1p, Cp, H4p, P, Pp;
  int stages, vec;  // ring depth; 16-byte row loads
  int cps;          // hidden pass: HC-wide chunks a work item
};

// Shared memory of one block, in bytes: the resident A tile (rows x Cp
// rounded up to 64), the ring, the barriers, and slack to align the base
// to 1024. kernels/block_core.py::fwd_smem_bytes mirrors this.
__host__ __device__ inline int smem_bytes(int rows, int cp, int pn, int hc, int stages) {
  const int ck = (cp + 63) / 64;
  const int stage = (pn > hc ? pn : hc) * 128;
  return 1024 + ck * rows * 128 + stages * stage + 2 * 8 * stages;
}

__device__ __forceinline__ float gelu_tanh(float v) {
  const float k0 = 0.7978845608028654f;  // sqrt(2 / pi)
  const float k1 = 0.044715f;
  return 0.5f * v * (1.0f + tanhf(k0 * (v + k1 * v * v * v)));
}

__device__ __forceinline__ float gelu_erf(float v) {
  return 0.5f * v * (1.0f + erff(v * 0.7071067811865476f));
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// GELU of the hidden value v (bias added): tanh on v rounded to bf16, or
// the exact one on the f32 v
template <bool TANH>
__device__ __forceinline__ float gelu(float v) {
  return TANH ? gelu_tanh(round_bf16(v)) : gelu_erf(v);
}

// Rows [row0, row0 + 64) of the parts, laid side by side (b from column
// C1p) into the swizzled A tile of this warpgroup (`tile`: atom 0 of the
// block's tile plus this warpgroup's row offset; atoms `atom` bytes apart),
// normalized with per-(image, channel) statistics when mean_a is given.
// Zeros past M and in the padding columns.
__device__ void load_rows(unsigned char* tile, int atom, const Args& a, long long row0,
                          const bf16* pa, const bf16* pb, const float* mean_a,
                          const float* rsig_a, const float* mean_b, const float* rsig_b) {
  const int t = threadIdx.x % 128;
  const int chunks = (a.Cp + 63) / 64 * 8;  // 16-byte chunks of a row
  for (int item = t; item < 64 * chunks; item += 128) {
    const int r = item / chunks, ch = item % chunks, c0 = ch * 8;
    const long long row = row0 + r;
    float v[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = 0.0f;
    if (row < a.M) {
      const long long img = row / a.HW;
      if (a.vec) {
        // whole chunks: a part's width is a multiple of 8
        const bf16* src = nullptr;
        const float *mean = nullptr, *rsig = nullptr;
        if (c0 < a.C1) {
          src = pa + row * a.C1 + c0;
          if (mean_a) mean = mean_a + img * a.C1 + c0, rsig = rsig_a + img * a.C1 + c0;
        } else if (c0 >= a.C1p && c0 < a.C1p + a.C2) {
          src = pb + row * a.C2 + (c0 - a.C1p);
          const long long off = img * a.C2 + (c0 - a.C1p);
          if (mean_b) mean = mean_b + off, rsig = rsig_b + off;
        }
        if (src) {
          const uint4 raw = *reinterpret_cast<const uint4*>(src);
          const bf16* h8 = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
          for (int e = 0; e < 8; ++e) v[e] = __bfloat162float(h8[e]);
          if (mean) {
            const float4 m0 = *reinterpret_cast<const float4*>(mean);
            const float4 m1 = *reinterpret_cast<const float4*>(mean + 4);
            const float4 s0 = *reinterpret_cast<const float4*>(rsig);
            const float4 s1 = *reinterpret_cast<const float4*>(rsig + 4);
            const float m[8] = {m0.x, m0.y, m0.z, m0.w, m1.x, m1.y, m1.z, m1.w};
            const float s[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
#pragma unroll
            for (int e = 0; e < 8; ++e) v[e] = (v[e] - m[e]) * s[e];
          }
        }
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int c = c0 + e;
          if (c < a.C1) {
            v[e] = __bfloat162float(pa[row * a.C1 + c]);
            if (mean_a) v[e] = (v[e] - mean_a[img * a.C1 + c]) * rsig_a[img * a.C1 + c];
          } else if (c >= a.C1p && c < a.C1p + a.C2) {
            const int cb = c - a.C1p;
            v[e] = __bfloat162float(pb[row * a.C2 + cb]);
            if (mean_b) v[e] = (v[e] - mean_b[img * a.C2 + cb]) * rsig_b[img * a.C2 + cb];
          }
        }
      }
    }
    uint4 packed;
    packed.x = pack_bf16(v[0], v[1]);
    packed.y = pack_bf16(v[2], v[3]);
    packed.z = pack_bf16(v[4], v[5]);
    packed.w = pack_bf16(v[6], v[7]);
    *reinterpret_cast<uint4*>(swz128(tile + (ch / 8) * atom, r, ch % 8)) = packed;
  }
}

// The consumers' side of the ring: wait() returns the next stage once its
// tile has landed; done(), after the warpgroup has committed its wgmma on
// it, waits for them and hands the stage back (every consumer warp does).
struct Ring {
  unsigned char* base;
  uint64_t *full, *empty;
  int stages, stage_bytes, stage = 0;
  uint32_t phase = 0;

  __device__ unsigned char* wait() {
    bar_wait(&full[stage], phase);
    return base + stage * stage_bytes;
  }
  __device__ void done() {
    mma_wait<0>();
    if (threadIdx.x % 32 == 0) bar_arrive(&empty[stage]);
    if (++stage == stages) stage = 0, phase ^= 1;
  }
};

// The producer's side: one thread fills stage after stage.
struct Feed {
  unsigned char* base;
  uint64_t *full, *empty;
  int stages, stage_bytes, stage = 0;
  uint32_t phase = 0;

  __device__ unsigned char* next(uint32_t bytes) {
    bar_wait(&empty[stage], phase ^ 1);
    bar_expect_tx(&full[stage], bytes);
    return base + stage * stage_bytes;
  }
  __device__ uint64_t* bar() { return &full[stage]; }
  __device__ void advance() {
    if (++stage == stages) stage = 0, phase ^= 1;
  }
};

// The barriers of a ring of `stages` stages after the ring at `ring`:
// full (one arrival: the producer's, with the bytes) and empty (one from
// each of the `consumer_warps`).
__device__ uint64_t* init_ring(unsigned char* ring, int stages, int stage_bytes,
                               int consumer_warps) {
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + stages * stage_bytes);
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      bar_init(&full[s], 1);
      bar_init(&full[stages + s], consumer_warps);
    }
    bar_init_fence();
  }
  __syncthreads();
  return full;
}

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(p) + 1023) &
                                          ~static_cast<uintptr_t>(1023));
}

// + b2, one rounding, out: this warpgroup's accumulator (64 x N) holds
// rows row0.. and columns p0.. of the (M, P) output.
template <int N>
__device__ void store_out(const float (&acc)[N / 2], const bf16* b2, bf16* out, long long M,
                          int P, long long row0, int p0) {
  const bool pairs = (P % 2) == 0;
#pragma unroll
  for (int i = 0; i < N / 2; i += 2) {
    const long long row = row0 + acc_row(i);
    const int n = p0 + acc_col(i);
    if (row >= M || n >= P) continue;
    const float v0 = acc[i] + __bfloat162float(b2[n]);
    bf16* dst = out + row * P + n;
    if (pairs) {
      const float v1 = acc[i + 1] + __bfloat162float(b2[n + 1]);
      *reinterpret_cast<uint32_t*>(dst) = pack_bf16(v0, v1);
    } else {
      dst[0] = __float2bfloat16_rn(v0);
      if (n + 1 < P) dst[1] = __float2bfloat16_rn(acc[i + 1] + __bfloat162float(b2[n + 1]));
    }
  }
}

// The fused route, and (HIDDEN) pass 1 of the two-pass route: work items
// (row tile, part), where a part is PN output columns or, HIDDEN, a.cps
// hidden chunks of HC columns whose GELU goes to the scratch a.out.
template <int NWG, int PN, int HC, bool TANH, bool HIDDEN>
__global__ void __launch_bounds__(128 * (NWG + 1), 1)
    bc2_fwd_sm90_kernel(const __grid_constant__ CUtensorMap w1t,
                        const __grid_constant__ CUtensorMap w2t,
                        const __grid_constant__ CUtensorMap wst, const Args a) {
  constexpr int ROWS = 64 * NWG;
  constexpr int STAGE = (PN > HC ? PN : HC) * 128;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  const int ck = (a.Cp + 63) / 64;           // 64-wide K steps over the input channels
  const int nj = (a.H4p + HC - 1) / HC;      // hidden chunks
  unsigned char* a_tile = smem;              // ck atoms of ROWS x 128 bytes
  unsigned char* ring = smem + ck * ROWS * 128;
  uint64_t* full = init_ring(ring, a.stages, STAGE, 4 * NWG);
  uint64_t* empty = full + a.stages;
  // work items: row tile w / parts, part w % parts; the block walks
  // blockIdx.x, blockIdx.x + gridDim.x, ...
  const int parts = HIDDEN ? (nj + a.cps - 1) / a.cps : (a.Pp + PN - 1) / PN;
  const long long items = (a.M + ROWS - 1) / ROWS * parts;
  auto chunks = [&](int part, int* j0, int* j1) {
    *j0 = HIDDEN ? part * a.cps : 0;
    *j1 = HIDDEN ? min(nj, *j0 + a.cps) : nj;
  };

  const int wg = threadIdx.x / 128;
  if (wg == NWG) {
    // producer: one thread walks the tiles in the consumers' order
    if constexpr (NWG == 2) regs_shrink<40>();
    if (threadIdx.x % 128 == 0) {
      Feed f{ring, full, empty, a.stages, STAGE};
      auto load = [&](const CUtensorMap* map, int col, int row, uint32_t bytes) {
        tma_load(f.next(bytes), map, f.bar(), col, row);
        f.advance();
      };
      for (long long w = blockIdx.x; w < items; w += gridDim.x) {
        const int part = w % parts, p0 = part * PN;
        int j0, j1;
        chunks(part, &j0, &j1);
        if constexpr (!HIDDEN)
          for (int k = 0; k < ck; ++k) load(&wst, 64 * k, p0, PN * 128);
        for (int j = j0; j < j1; ++j) {
          for (int k = 0; k < ck; ++k) load(&w1t, 64 * k, j * HC, HC * 128);
          if constexpr (!HIDDEN)
            for (int k = 0; k < HC / 64; ++k) load(&w2t, j * HC + 64 * k, p0, PN * 128);
        }
      }
    }
  } else {
    if constexpr (NWG == 2) regs_grow<232>();
    const int t = threadIdx.x % 128;
    unsigned char* my_a = a_tile + wg * 64 * 128;  // this warpgroup's rows of atom 0
    const int atom = ROWS * 128;
    Ring rg{ring, full, empty, a.stages, STAGE};
    for (long long w = blockIdx.x; w < items; w += gridDim.x) {
      const long long row0 = w / parts * ROWS + 64 * wg;
      const int part = w % parts, p0 = part * PN;
      int j0, j1;
      chunks(part, &j0, &j1);
      // the previous item's products have read the A tile
      sync_threads(1 + wg, 128);
      float acc[PN / 2];
      if constexpr (!HIDDEN) {
        // shortcut: acc = x @ Ws
        load_rows(my_a, atom, a, row0, a.xa, a.xb, nullptr, nullptr, nullptr, nullptr);
        fence_async_smem();
        sync_threads(1 + wg, 128);
#pragma unroll
        for (int i = 0; i < PN / 2; ++i) acc[i] = 0.0f;
        hold(acc);
        for (int k = 0; k < ck; ++k) {
          unsigned char* b = rg.wait();
          mma_fence();
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            mma_ss<PN, 0, 0>(acc, desc_kmajor(my_a + k * atom + 32 * kk),
                             desc_kmajor(b + 32 * kk), 1);
          mma_commit();
          rg.done();
        }
        hold(acc);
        sync_threads(1 + wg, 128);
      }

      // the normalized input, rounded once to bf16 (in place of x)
      load_rows(my_a, atom, a, row0, a.ha, a.hb, a.mean_a, a.rsig_a, a.mean_b, a.rsig_b);
      fence_async_smem();
      sync_threads(1 + wg, 128);

      for (int j = j0; j < j1; ++j) {
        // GEMM1: hid = a @ W1[:, chunk j], into registers
        float hid[HC / 2];
        hold(hid);
        for (int k = 0; k < ck; ++k) {
          unsigned char* b = rg.wait();
          mma_fence();
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            mma_ss<HC, 0, 0>(hid, desc_kmajor(my_a + k * atom + 32 * kk), desc_kmajor(b + 32 * kk),
                             k > 0 || kk > 0);
          mma_commit();
          rg.done();
        }
        hold(hid);
        if constexpr (HIDDEN) {
          // bias + GELU, the bf16 hidden to the scratch
#pragma unroll
          for (int n8 = 0; n8 < HC / 8; ++n8) {
            const int col = j * HC + 8 * n8 + 2 * (t % 4);
            if (col >= a.H4p) continue;
            const __nv_bfloat162 bb = *reinterpret_cast<const __nv_bfloat162*>(a.b1 + col);
            const float bias[2] = {__low2float(bb), __high2float(bb)};
            float g[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) g[e] = gelu<TANH>(hid[4 * n8 + e] + bias[e % 2]);
            const long long r = row0 + acc_row(4 * n8);
            if (r < a.M) *reinterpret_cast<uint32_t*>(a.out + r * a.H4p + col) = pack_bf16(g[0], g[1]);
            if (r + 8 < a.M)
              *reinterpret_cast<uint32_t*>(a.out + (r + 8) * a.H4p + col) = pack_bf16(g[2], g[3]);
          }
        } else {
          hold(acc);
          // bias + GELU in registers, packed as GEMM2's A fragments
          uint32_t frag[HC / 16][4];
#pragma unroll
          for (int n8 = 0; n8 < HC / 8; ++n8) {
            const int col = j * HC + 8 * n8 + 2 * (t % 4);
            float bias[2] = {0.0f, 0.0f};
            if (col < a.H4p) {
              const __nv_bfloat162 bb = *reinterpret_cast<const __nv_bfloat162*>(a.b1 + col);
              bias[0] = __low2float(bb), bias[1] = __high2float(bb);
            }
            float g[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) g[e] = gelu<TANH>(hid[4 * n8 + e] + bias[e % 2]);
            frag[n8 / 2][(n8 % 2) * 2] = pack_bf16(g[0], g[1]);
            frag[n8 / 2][(n8 % 2) * 2 + 1] = pack_bf16(g[2], g[3]);
          }
          // GEMM2: acc += bf16(gelu) @ W2[chunk j, p0:p0+PN]
#pragma unroll
          for (int k = 0; k < HC / 64; ++k) {
            unsigned char* b = rg.wait();
            mma_fence();
#pragma unroll
            for (int kk = 0; kk < 4; ++kk)
              mma_rs<PN>(acc, frag[4 * k + kk], desc_kmajor(b + 32 * kk), 1);
            mma_commit();
            rg.done();
          }
        }
      }
      if constexpr (!HIDDEN) {
        hold(acc);
        store_out<PN>(acc, a.b2, a.out, a.M, a.P, row0, p0);
      }
    }
  }
}

// Pass 2 of the two-pass route: out = [hid | x_a | x_b] @ [W2; Wsa; Wsb]
// + b2 for 128 rows x BN columns a work item; every stage holds an A box
// (128 rows x 64, K-major) and a B box (BN rows of the transposed weight x
// 64, K-major).
struct OutArgs {
  const bf16* b2;
  bf16* out;
  long long M;
  int P, Pp, C1p;
  int kg, kxa, kxb;  // 64-wide K steps over the hidden, part a and part b
};

template <int BN>
__global__ void __launch_bounds__(384, 1)
    bc_fwd_out_sm90_kernel(const __grid_constant__ CUtensorMap m_hid,
                           const __grid_constant__ CUtensorMap m_xa,
                           const __grid_constant__ CUtensorMap m_xb,
                           const __grid_constant__ CUtensorMap m_w2t,
                           const __grid_constant__ CUtensorMap m_wst, const OutArgs o) {
  constexpr int STAGE = 16384 + BN * 128;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = align1024(smem_raw);
  uint64_t* full = init_ring(ring, OUT_STAGES, STAGE, 8);
  uint64_t* empty = full + OUT_STAGES;
  const int ncol = (o.Pp + BN - 1) / BN;
  const long long items = (o.M + 127) / 128 * ncol;
  const int wg = threadIdx.x / 128;

  if (wg == 2) {
    regs_shrink<40>();
    if (threadIdx.x % 128 == 0) {
      Feed f{ring, full, empty, OUT_STAGES, STAGE};
      auto load = [&](const CUtensorMap* ma, const CUtensorMap* mb, int acol, int bcol, int row0,
                      int n0) {
        unsigned char* st = f.next(STAGE);
        tma_load(st, ma, f.bar(), acol, row0);
        tma_load(st + 16384, mb, f.bar(), bcol, n0);
        f.advance();
      };
      for (long long w = blockIdx.x; w < items; w += gridDim.x) {
        const int row0 = (int)(w / ncol * 128), n0 = (int)(w % ncol) * BN;
        for (int k = 0; k < o.kg; ++k) load(&m_hid, &m_w2t, 64 * k, 64 * k, row0, n0);
        for (int k = 0; k < o.kxa; ++k) load(&m_xa, &m_wst, 64 * k, 64 * k, row0, n0);
        for (int k = 0; k < o.kxb; ++k) load(&m_xb, &m_wst, 64 * k, o.C1p + 64 * k, row0, n0);
      }
    }
  } else {
    regs_grow<232>();
    Ring rg{ring, full, empty, OUT_STAGES, STAGE};
    const int steps = o.kg + o.kxa + o.kxb;
    for (long long w = blockIdx.x; w < items; w += gridDim.x) {
      float acc[BN / 2];
      hold(acc);
      for (int k = 0; k < steps; ++k) {
        unsigned char* st = rg.wait();
        mma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          mma_ss<BN, 0, 0>(acc, desc_kmajor(st + wg * 8192 + 32 * kk),
                           desc_kmajor(st + 16384 + 32 * kk), k > 0 || kk > 0);
        mma_commit();
        rg.done();
      }
      hold(acc);
      store_out<BN>(acc, o.b2, o.out, o.M, o.P, w / ncol * 128 + 64 * wg, (int)(w % ncol) * BN);
    }
  }
}

// The narrow route: one input of C <= NARROW_C channels, so the hidden is
// one 16-wide tile (H4p = 16). One thread a row; the weights in shared
// memory as f32 (every thread of a warp reads the same word: broadcast):
// W1 and b1, then W2, Ws and b2 in rows of Pp; then the block's output
// rows, staged so that the block stores its rows (contiguous in the
// output) 16 coalesced bytes a thread.
struct NarrowArgs {
  const bf16 *h, *x;
  const float *mean, *rsig;
  const bf16 *w1, *b1, *w2, *b2, *ws;
  bf16* out;
  long long M;
  int HW, C, P, Pp;
};

__host__ __device__ inline int narrow_smem_bytes(int pp) {
  return 4 * (NARROW_C * NARROW_H + NARROW_H + (NARROW_H + NARROW_C + 1) * pp) +
         NARROW_THREADS * (2 * pp + 16);
}

template <bool TANH>
__global__ void __launch_bounds__(NARROW_THREADS) bc_fwd_narrow_kernel(const NarrowArgs a) {
  extern __shared__ __align__(16) float nsm[];
  float* w1 = nsm;                       // NARROW_C x 16
  float* b1 = w1 + NARROW_C * NARROW_H;  // 16
  float* w2 = b1 + NARROW_H;             // 16 x Pp
  float* ws = w2 + NARROW_H * a.Pp;      // NARROW_C x Pp
  float* b2 = ws + NARROW_C * a.Pp;      // Pp
  // the output rows, 16 bytes apart beyond their Pp values against bank conflicts
  unsigned char* staged = reinterpret_cast<unsigned char*>(b2 + a.Pp);
  const int ld = 2 * a.Pp + 16;
  for (int i = threadIdx.x; i < NARROW_C * NARROW_H; i += NARROW_THREADS)
    w1[i] = i / NARROW_H < a.C ? __bfloat162float(a.w1[i]) : 0.0f;
  for (int i = threadIdx.x; i < NARROW_H; i += NARROW_THREADS) b1[i] = __bfloat162float(a.b1[i]);
  for (int i = threadIdx.x; i < (NARROW_H + NARROW_C + 1) * a.Pp; i += NARROW_THREADS) {
    const int r = i / a.Pp, n = i % a.Pp;
    float v;
    if (r < NARROW_H) v = __bfloat162float(a.w2[i]);
    else if (r < NARROW_H + NARROW_C) v = r - NARROW_H < a.C ? __bfloat162float(a.ws[i - NARROW_H * a.Pp]) : 0.0f;
    else v = __bfloat162float(a.b2[n]);
    w2[i] = v;
  }
  __syncthreads();

  const int t = threadIdx.x;
  for (long long row0 = (long long)blockIdx.x * NARROW_THREADS; row0 < a.M;
       row0 += (long long)gridDim.x * NARROW_THREADS) {
    const long long row = row0 + t;
    const int img = row < a.M ? (int)(row / a.HW) : 0;
    float av[NARROW_C], xv[NARROW_C];
#pragma unroll
    for (int c = 0; c < NARROW_C; ++c) {
      av[c] = 0.0f, xv[c] = 0.0f;
      if (row < a.M && c < a.C) {
        const int s = img * a.C + c;
        av[c] = round_bf16((__bfloat162float(a.h[row * a.C + c]) - a.mean[s]) * a.rsig[s]);
        xv[c] = __bfloat162float(a.x[row * a.C + c]);
      }
    }
    float g[NARROW_H];
#pragma unroll
    for (int j = 0; j < NARROW_H; ++j) {
      float s = 0.0f;
#pragma unroll
      for (int c = 0; c < NARROW_C; ++c) s = fmaf(av[c], w1[c * NARROW_H + j], s);
      g[j] = round_bf16(gelu<TANH>(s + b1[j]));
    }
    for (int n0 = 0; n0 < a.Pp; n0 += 8) {
      float o[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) o[e] = 0.0f;
      auto fma8 = [&](float v, const float* wrow) {
        const float4 lo = *reinterpret_cast<const float4*>(wrow + n0);
        const float4 hi = *reinterpret_cast<const float4*>(wrow + n0 + 4);
        const float w[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
        for (int e = 0; e < 8; ++e) o[e] = fmaf(v, w[e], o[e]);
      };
      // the shortcut first, then the hidden, as the wgmma routes sum
#pragma unroll
      for (int c = 0; c < NARROW_C; ++c) fma8(xv[c], ws + c * a.Pp);
#pragma unroll
      for (int j = 0; j < NARROW_H; ++j) fma8(g[j], w2 + j * a.Pp);
      uint4 packed;
      packed.x = pack_bf16(o[0] + b2[n0], o[1] + b2[n0 + 1]);
      packed.y = pack_bf16(o[2] + b2[n0 + 2], o[3] + b2[n0 + 3]);
      packed.z = pack_bf16(o[4] + b2[n0 + 4], o[5] + b2[n0 + 5]);
      packed.w = pack_bf16(o[6] + b2[n0 + 6], o[7] + b2[n0 + 7]);
      *reinterpret_cast<uint4*>(staged + t * ld + 2 * n0) = packed;
    }
    __syncthreads();
    // the block's rows are contiguous in the output
    const int nrows = (int)min((long long)NARROW_THREADS, a.M - row0);
    bf16* out = a.out + row0 * a.P;
    if (a.P % 8 == 0) {
      const int per_row = a.P / 8;
      for (int i = t; i < nrows * per_row; i += NARROW_THREADS)
        reinterpret_cast<uint4*>(out)[i] =
            *reinterpret_cast<const uint4*>(staged + i / per_row * ld + 16 * (i % per_row));
    } else {
      for (int i = t; i < nrows * a.P; i += NARROW_THREADS)
        out[i] = reinterpret_cast<const bf16*>(staged + i / a.P * ld)[i % a.P];
    }
    __syncthreads();
  }
}

template <int NWG, int PN, int HC, bool HIDDEN>
int launch(int tanh_gelu, const CUtensorMap& w1t, const CUtensorMap& w2t, const CUtensorMap& wst,
           const Args& a, cudaStream_t stream) {
  auto kernel = tanh_gelu ? bc2_fwd_sm90_kernel<NWG, PN, HC, true, HIDDEN>
                          : bc2_fwd_sm90_kernel<NWG, PN, HC, false, HIDDEN>;
  const int smem = smem_bytes(64 * NWG, a.Cp, PN, HC, a.stages);
  int err = allow_smem(reinterpret_cast<const void*>(kernel), smem);
  // persistent: one block on each SM, or one per item where fewer
  int sms = 0;
  if (err || (err = sm_count(&sms))) return err;
  const int nj = (a.H4p + HC - 1) / HC;
  const int parts = HIDDEN ? (nj + a.cps - 1) / a.cps : (a.Pp + PN - 1) / PN;
  const long long items = (a.M + 64 * NWG - 1) / (64 * NWG) * parts;
  kernel<<<(unsigned)(items < sms ? items : sms), 128 * (NWG + 1), smem, stream>>>(w1t, w2t, wst,
                                                                                   a);
  return (int)cudaGetLastError();
}

template <int BN>
int launch_out(const CUtensorMap (&maps)[5], const OutArgs& o, cudaStream_t stream) {
  const int smem = 1024 + OUT_STAGES * (16384 + BN * 128) + 2 * 8 * OUT_STAGES;
  int err = allow_smem(reinterpret_cast<const void*>(bc_fwd_out_sm90_kernel<BN>), smem);
  int sms = 0;
  if (err || (err = sm_count(&sms))) return err;
  const long long items = (o.M + 127) / 128 * ((o.Pp + BN - 1) / BN);
  bc_fwd_out_sm90_kernel<BN><<<(unsigned)(items < sms ? items : sms), 384, smem, stream>>>(
      maps[0], maps[1], maps[2], maps[3], maps[4], o);
  return (int)cudaGetLastError();
}

Args make_args(const void* ha, const void* hb, const void* xa, const void* xb,
               const float* mean_a, const float* rsig_a, const float* mean_b, const float* rsig_b,
               const void* b1, const void* b2, void* out, long long M, int HW, int C1, int C2,
               int C1p, int Cp, int H4p, int P, int Pp, int stages, int vec, int cps) {
  return Args{static_cast<const bf16*>(ha), static_cast<const bf16*>(hb),
              static_cast<const bf16*>(xa), static_cast<const bf16*>(xb),
              mean_a, rsig_a, mean_b, rsig_b,
              static_cast<const bf16*>(b1), static_cast<const bf16*>(b2), static_cast<bf16*>(out),
              M, HW, C1, C2, C1p, Cp, H4p, P, Pp, stages, vec, cps};
}

}  // namespace

extern "C" {

// K1 / K3, the fused route. ha, hb, xa, xb: (M, C1) and (M, C2) rows (hb,
// xb, mean_b, rsig_b null and C2 = 0 for one input); mean, rsig: (B, C)
// f32; w1t (H4p, Cp), w2t (Pp, H4p), wst (Pp, Cp): the packed weights
// transposed (part b's input channels from column C1p); b1 (H4p), b2 (Pp).
// The plan (kernels/block_core.py::fwd_plan): nwg consumer warpgroups of
// 64 rows, pn output columns and hc hidden columns a work item, `stages`
// ring stages; vec: 16-byte row loads. Returns 0 or the first error (a
// cudaError_t, or sm90::ERR_TENSOR_MAP).
int block_core2_fwd_sm90(int tanh_gelu, const void* ha, const void* hb, const void* xa,
                         const void* xb, const float* mean_a, const float* rsig_a,
                         const float* mean_b, const float* rsig_b, const void* w1t, const void* b1,
                         const void* w2t, const void* b2, const void* wst, void* out, long long M,
                         int HW, int C1, int C2, int C1p, int Cp, int H4p, int P, int Pp, int nwg,
                         int pn, int hc, int stages, int vec, void* stream) {
  const Args a = make_args(ha, hb, xa, xb, mean_a, rsig_a, mean_b, rsig_b, b1, b2, out, M, HW, C1,
                           C2, C1p, Cp, H4p, P, Pp, stages, vec, 0);
  CUtensorMap m1, m2, ms;
  int e = tensor_map(&m1, w1t, H4p, Cp, Cp, 64, hc);
  if (!e) e = tensor_map(&m2, w2t, Pp, H4p, H4p, 64, pn);
  if (!e) e = tensor_map(&ms, wst, Pp, Cp, Cp, 64, pn);
  if (e) return e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nwg == 2 && pn == 64 && hc == 128) return launch<2, 64, 128, false>(tanh_gelu, m1, m2, ms, a, s);
  if (nwg == 2 && pn == 128 && hc == 128) return launch<2, 128, 128, false>(tanh_gelu, m1, m2, ms, a, s);
  if (nwg == 2 && pn == 256 && hc == 64) return launch<2, 256, 64, false>(tanh_gelu, m1, m2, ms, a, s);
  if (nwg == 1 && pn == 64 && hc == 128) return launch<1, 64, 128, false>(tanh_gelu, m1, m2, ms, a, s);
  if (nwg == 1 && pn == 128 && hc == 128) return launch<1, 128, 128, false>(tanh_gelu, m1, m2, ms, a, s);
  if (nwg == 1 && pn == 256 && hc == 64) return launch<1, 256, 64, false>(tanh_gelu, m1, m2, ms, a, s);
  return (int)cudaErrorInvalidValue;
}

// K1 / K3, the two-pass route: arguments as block_core2_fwd_sm90, plus hid,
// an (M, H4p) bf16 scratch. Pass 1 on nwg warpgroups and `stages` stages,
// cps 128-wide hidden chunks a work item; pass 2 in bn-wide column blocks.
// xa and xb are read by TMA: 16-byte aligned, C1 and C2 multiples of 8.
int block_core_fwd_sm90_two_pass(int tanh_gelu, const void* ha, const void* hb, const void* xa,
                                 const void* xb, const float* mean_a, const float* rsig_a,
                                 const float* mean_b, const float* rsig_b, const void* w1t,
                                 const void* b1, const void* w2t, const void* b2, const void* wst,
                                 void* hid, void* out, long long M, int HW, int C1, int C2,
                                 int C1p, int Cp, int H4p, int P, int Pp, int nwg, int cps, int bn,
                                 int stages, int vec, void* stream) {
  const Args a = make_args(ha, hb, xa, xb, mean_a, rsig_a, mean_b, rsig_b, b1, b2, hid, M, HW, C1,
                           C2, C1p, Cp, H4p, P, Pp, stages, vec, cps);
  CUtensorMap m1, maps[5];  // hid, xa, xb, w2t, wst
  int e = tensor_map(&m1, w1t, H4p, Cp, Cp, 64, 128);
  if (!e) e = tensor_map(&maps[0], hid, M, H4p, H4p, 64, 128);
  if (!e) e = tensor_map(&maps[1], xa, M, C1, C1, 64, 128);
  if (!e) e = tensor_map(&maps[2], C2 ? xb : xa, M, C2 ? C2 : C1, C2 ? C2 : C1, 64, 128);
  if (!e) e = tensor_map(&maps[3], w2t, Pp, H4p, H4p, 64, bn);
  if (!e) e = tensor_map(&maps[4], wst, Pp, Cp, Cp, 64, bn);
  if (e) return e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nwg == 2) e = launch<2, 64, 128, true>(tanh_gelu, m1, m1, m1, a, s);
  else if (nwg == 1) e = launch<1, 64, 128, true>(tanh_gelu, m1, m1, m1, a, s);
  else e = (int)cudaErrorInvalidValue;
  if (e) return e;
  const OutArgs o{static_cast<const bf16*>(b2), static_cast<bf16*>(out), M, P, Pp, C1p,
                  H4p / 64 + (H4p % 64 != 0), (C1 + 63) / 64, (C2 + 63) / 64};
  if (bn == 128) return launch_out<128>(maps, o, s);
  if (bn == 256) return launch_out<256>(maps, o, s);
  return (int)cudaErrorInvalidValue;
}

// K1, the narrow route (C <= 4): h, x (M, C) rows; mean, rsig (B, C) f32;
// the packed weights w1 (16, 16), b1 (16), w2 (16, Pp), b2 (Pp), ws (16,
// Pp).
int block_core_fwd_narrow(int tanh_gelu, const void* h, const void* x, const float* mean,
                          const float* rsig, const void* w1, const void* b1, const void* w2,
                          const void* b2, const void* ws, void* out, long long M, int HW, int C,
                          int P, int Pp, void* stream) {
  if (C > NARROW_C) return (int)cudaErrorInvalidValue;
  auto bp = [](const void* p) { return static_cast<const bf16*>(p); };
  const NarrowArgs a{bp(h), bp(x), mean, rsig, bp(w1), bp(b1), bp(w2), bp(b2), bp(ws),
                     static_cast<bf16*>(out), M, HW, C, P, Pp};
  auto kernel = tanh_gelu ? bc_fwd_narrow_kernel<true> : bc_fwd_narrow_kernel<false>;
  const int smem = narrow_smem_bytes(Pp);
  int err = allow_smem(reinterpret_cast<const void*>(kernel), smem);
  int sms = 0;
  if (err || (err = sm_count(&sms))) return err;
  const long long blocks = (M + NARROW_THREADS - 1) / NARROW_THREADS, most = 16LL * sms;
  kernel<<<(unsigned)(blocks < most ? blocks : most), NARROW_THREADS, smem,
           static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
