// Fused two-input ConvNeXt block core, forward, bf16, on Hopper's tensor
// cores through wgmma, fed by TMA (sm_90a).
//
// Replaces the TPU kernel K3 of dsgan_tpu/pallas/block_core.py:
// _fwd_kernel2 (:410-428) / _fwd2_impl (pallas_call at :553). Per pixel row
// r of the decoder's two channel parts a (C1 channels) and b (C2), NHWC
// flattened to (M, C1) and (M, C2), it computes
//
//   out[r] = bf16( gelu(bf16([a_a | a_b][r]) @ [W1a; W1b] + b1) @ W2 + b2
//                  + [x_a | x_b][r] @ [Wsa; Wsb] ),   a = (h - mean) * rsig
//
// with the tanh GELU on the bf16-rounded hidden (or the exact one on the
// f32 hidden), every sum in f32 and one final rounding. The 2C-wide concat
// and the 4C-wide hidden never reach device memory. The f32 check build of
// K3 stays in block_core.cu; this file holds the bf16 path alone.
//
// What bounds it: 2(4C^2 + 4CP + CP) operations a row against 2(2C + P)
// bytes a row, so at the decoder's sites, batch 16, it is operations-bound
// with the same 0.226 ms at every site (uc1 C = 1024, P = 512: M = 16,384;
// uc2 512/256: 65,536; uc3 256/128: 262,144; uc4 128/64: 1,048,576 rows;
// 223 GFLOP at 989 TFLOP/s), against 0.03-0.08 ms of bytes. The weights
// are what a row tile reads most: every block reads all of W1, W2 and Ws,
// so the rows per block set the L2 -> SM traffic (7 GB a site at 32 rows).
//
// Design. A block owns 128 rows (64 where shared memory or the card's 132
// SMs ask for it) and PN <= 256 output columns: two consumer warpgroups of
// 64 rows each and one producer warp. The producer streams every weight
// tile the block needs, in the order the consumers use them, through a
// ring of S stages in 128-byte-swizzled shared memory: TMA boxes of
// Ws^T, then per hidden chunk of HC columns the W1^T tiles and the W2^T
// tiles (the wrapper packs the weights transposed, so every B operand is
// K-major), each stage guarded by a full and an empty mbarrier. The
// consumers normalize their rows into a resident swizzled A tile (16-byte
// loads where each part's width is a multiple of 8, element by element
// otherwise; TMA cannot normalize), first x for the shortcut, then
// (h - mean) * rsig. Per hidden chunk, GEMM1 (m64 x HC, K = Cp) runs into
// registers, bias and GELU run in registers, and the bf16 result is handed
// to GEMM2 as wgmma's register A operand (the accumulator layout is the A
// fragment layout), so the hidden never leaves the registers. The output
// accumulator (64 x PN f32, 128 registers at PN = 256) stays in registers
// throughout; consumers take 232 registers through setmaxnreg. Blocks are
// persistent: one a SM walks the (row tile, column block) items, its
// producer running ahead into the next item.
//
// P = 512 (uc1): the output columns split over two blocks, each
// recomputing GEMM1 (+61% operations at uc1). Its 1024-wide input also
// keeps uc1 at 64-row tiles (the resident A tile is 128 KB). The other
// way, two warpgroups owning halves of P over one shared hidden tile,
// needs 64 KB W2^T stages (512 rows of 128 bytes) beside that A tile:
// two stages and the hidden tile come to 264 KB, past the 227 KB a block
// may have, so it was not built.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace sm90;

struct Args {
  const bf16 *ha, *hb, *xa, *xb;
  const float *mean_a, *rsig_a, *mean_b, *rsig_b;
  const bf16 *b1, *b2;
  bf16* out;
  long long M;  // rows: batch * HW
  int HW, C1, C2, C1p, Cp, H4p, P, Pp;
  int stages, vec;  // ring depth; 16-byte row loads
};

// Shared memory of one block, in bytes: the resident A tile (rows x Cp
// rounded up to 64), the ring, the barriers, and slack to align the base
// to 1024. kernels/block_core.py::k3_plan mirrors this.
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

template <int NWG, int PN, int HC, bool TANH>
__global__ void __launch_bounds__(128 * (NWG + 1), 1)
    bc2_fwd_sm90_kernel(const __grid_constant__ CUtensorMap w1t,
                        const __grid_constant__ CUtensorMap w2t,
                        const __grid_constant__ CUtensorMap wst, const Args a) {
  constexpr int ROWS = 64 * NWG;
  constexpr int STAGE = (PN > HC ? PN : HC) * 128;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const int ck = (a.Cp + 63) / 64;           // 64-wide K steps over the input channels
  const int nj = (a.H4p + HC - 1) / HC;      // hidden chunks
  unsigned char* a_tile = smem;              // ck atoms of ROWS x 128 bytes
  unsigned char* ring = smem + ck * ROWS * 128;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + a.stages * STAGE);
  uint64_t* empty = full + a.stages;
  // work items: row tile w / splits, output columns from (w % splits) * PN;
  // the block walks blockIdx.x, blockIdx.x + gridDim.x, ...
  const int splits = (a.Pp + PN - 1) / PN;
  const long long items = (a.M + ROWS - 1) / ROWS * splits;

  if (threadIdx.x == 0) {
    for (int s = 0; s < a.stages; ++s) {
      bar_init(&full[s], 1);
      bar_init(&empty[s], 4 * NWG);  // every consumer warp hands a stage back
    }
    bar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == NWG) {
    // producer: one thread walks the tiles in the consumers' order
    if constexpr (NWG == 2) regs_shrink<40>();
    if (threadIdx.x % 128 == 0) {
      int stage = 0;
      uint32_t phase = 0;
      auto load = [&](const CUtensorMap* map, int col, int row, uint32_t bytes) {
        bar_wait(&empty[stage], phase ^ 1);
        bar_expect_tx(&full[stage], bytes);
        tma_load(ring + stage * STAGE, map, &full[stage], col, row);
        if (++stage == a.stages) stage = 0, phase ^= 1;
      };
      for (long long w = blockIdx.x; w < items; w += gridDim.x) {
        const int p0 = w % splits * PN;
        for (int k = 0; k < ck; ++k) load(&wst, 64 * k, p0, PN * 128);
        for (int j = 0; j < nj; ++j) {
          for (int k = 0; k < ck; ++k) load(&w1t, 64 * k, j * HC, HC * 128);
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
      const long long row0 = w / splits * ROWS + 64 * wg;
      const int p0 = w % splits * PN;
      // the previous item's products have read the A tile
      sync_threads(1 + wg, 128);
      // shortcut: acc = x @ Ws
      load_rows(my_a, atom, a, row0, a.xa, a.xb, nullptr, nullptr, nullptr, nullptr);
      fence_async_smem();
      sync_threads(1 + wg, 128);
      float acc[PN / 2];
#pragma unroll
      for (int i = 0; i < PN / 2; ++i) acc[i] = 0.0f;
      hold(acc);
      for (int k = 0; k < ck; ++k) {
        unsigned char* b = rg.wait();
        mma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          mma_ss<PN, 0, 0>(acc, desc_kmajor(my_a + k * atom + 32 * kk), desc_kmajor(b + 32 * kk),
                           1);
        mma_commit();
        rg.done();
      }
      hold(acc);

      // the normalized input, rounded once to bf16, in place of x
      sync_threads(1 + wg, 128);
      load_rows(my_a, atom, a, row0, a.ha, a.hb, a.mean_a, a.rsig_a, a.mean_b, a.rsig_b);
      fence_async_smem();
      sync_threads(1 + wg, 128);

      for (int j = 0; j < nj; ++j) {
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
          for (int e = 0; e < 4; ++e) {
            const float v = hid[4 * n8 + e] + bias[e % 2];
            g[e] = TANH ? gelu_tanh(__bfloat162float(__float2bfloat16_rn(v))) : gelu_erf(v);
          }
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
      hold(acc);

      // + b2, one rounding, out
      const bool pairs = (a.P % 2) == 0;
#pragma unroll
      for (int i = 0; i < PN / 2; i += 2) {
        const long long row = row0 + acc_row(i);
        const int n = p0 + acc_col(i);
        if (row >= a.M || n >= a.P) continue;
        const float v0 = acc[i] + __bfloat162float(a.b2[n]);
        bf16* dst = a.out + row * a.P + n;
        if (pairs) {
          const float v1 = acc[i + 1] + __bfloat162float(a.b2[n + 1]);
          *reinterpret_cast<uint32_t*>(dst) = pack_bf16(v0, v1);
        } else {
          dst[0] = __float2bfloat16_rn(v0);
          if (n + 1 < a.P)
            dst[1] = __float2bfloat16_rn(acc[i + 1] + __bfloat162float(a.b2[n + 1]));
        }
      }
    }
  }
}

template <int NWG, int PN, int HC>
int launch(int tanh_gelu, const CUtensorMap& w1t, const CUtensorMap& w2t, const CUtensorMap& wst,
           const Args& a, cudaStream_t stream) {
  auto kernel = tanh_gelu ? bc2_fwd_sm90_kernel<NWG, PN, HC, true>
                          : bc2_fwd_sm90_kernel<NWG, PN, HC, false>;
  const int smem = smem_bytes(64 * NWG, a.Cp, PN, HC, a.stages);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  // persistent: one block on each SM, or one per item where fewer
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  const long long items = (a.M + 64 * NWG - 1) / (64 * NWG) * ((a.Pp + PN - 1) / PN);
  kernel<<<(unsigned)(items < sms ? items : sms), 128 * (NWG + 1), smem, stream>>>(w1t, w2t, wst,
                                                                                   a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// K3, bf16. ha, hb, xa, xb: (M, C1) and (M, C2) rows; mean, rsig: (B, C)
// f32; w1t (H4p, Cp), w2t (Pp, H4p), wst (Pp, Cp): the packed weights
// transposed (part b's input channels from column C1p); b1 (H4p), b2
// (Pp). The plan (kernels/block_core.py::k3_plan): nwg consumer
// warpgroups of 64 rows, pn output columns and hc hidden columns a work
// item, `stages` ring stages; vec: 16-byte row loads. Returns 0 or the
// first error (a cudaError_t, or sm90::ERR_TENSOR_MAP).
int block_core2_fwd_sm90(int tanh_gelu, const void* ha, const void* hb, const void* xa,
                         const void* xb, const float* mean_a, const float* rsig_a,
                         const float* mean_b, const float* rsig_b, const void* w1t, const void* b1,
                         const void* w2t, const void* b2, const void* wst, void* out, long long M,
                         int HW, int C1, int C2, int C1p, int Cp, int H4p, int P, int Pp, int nwg,
                         int pn, int hc, int stages, int vec, void* stream) {
  Args a{static_cast<const bf16*>(ha), static_cast<const bf16*>(hb), static_cast<const bf16*>(xa),
         static_cast<const bf16*>(xb), mean_a, rsig_a, mean_b, rsig_b,
         static_cast<const bf16*>(b1), static_cast<const bf16*>(b2), static_cast<bf16*>(out),
         M, HW, C1, C2, C1p, Cp, H4p, P, Pp, stages, vec};
  CUtensorMap m1, m2, ms;
  int e = tensor_map(&m1, w1t, H4p, Cp, Cp, 64, hc);
  if (!e) e = tensor_map(&m2, w2t, Pp, H4p, H4p, 64, pn);
  if (!e) e = tensor_map(&ms, wst, Pp, Cp, Cp, 64, pn);
  if (e) return e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nwg == 2 && pn == 64 && hc == 128) return launch<2, 64, 128>(tanh_gelu, m1, m2, ms, a, s);
  if (nwg == 2 && pn == 128 && hc == 128) return launch<2, 128, 128>(tanh_gelu, m1, m2, ms, a, s);
  if (nwg == 2 && pn == 256 && hc == 64) return launch<2, 256, 64>(tanh_gelu, m1, m2, ms, a, s);
  if (nwg == 1 && pn == 64 && hc == 128) return launch<1, 64, 128>(tanh_gelu, m1, m2, ms, a, s);
  if (nwg == 1 && pn == 128 && hc == 128) return launch<1, 128, 128>(tanh_gelu, m1, m2, ms, a, s);
  if (nwg == 1 && pn == 256 && hc == 64) return launch<1, 256, 64>(tanh_gelu, m1, m2, ms, a, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
