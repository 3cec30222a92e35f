// Fused ConvNeXt block core, backward, f32 check build, for NVIDIA Hopper
// (sm_90a).
//
// Replaces the TPU kernels of dsgan_tpu/pallas/block_core.py in f32:
//   K2  _bwd_kernel  / _bwd_impl   (one input:  block_core_bwd)
//   K4  _bwd_kernel2 / _bwd2_impl  (two inputs: block_core_bwd with part b)
// The bf16 forms of both run on the tensor cores in
// block_core2_bwd_sm90.cu; this entry refuses bf16 (cudaErrorNotSupported).
//
// Given the forward's inputs and the cotangent g of its output, per pixel
// row r of the NHWC activations flattened to (M, C), with
//   a   = (h - mean) * rsig               the normalized input
//   h1  = a @ W1 + b1                     the hidden, recomputed
//   ag  = gelu(h1),  dg1 = (g @ W2^T) * gelu'(h1)
// it computes
//   dn  = dg1 @ W1^T          dx  = g @ Ws^T
//   dW1 = a^T dg1   db1 = sum dg1   dW2 = ag^T g   db2 = sum g
//   dWs = x^T g     S1 = sum_HW dn  S2 = sum_HW dn * (h - mean)
// with one tanh serving gelu and gelu' (the erf flavour: the exact
// derivative). The caller folds dn, S1 and S2 into the InstanceNorm
// cotangent. The two-input form takes h and x as two channel parts, as
// the forward does: the parts sit side by side in the shared tile, dn and
// dx come out per part, dW1 and dWs are written straight into the rows of
// the concat layout.
//
// It holds the structure of the bf16 kernels tightly against the plain
// PyTorch version in f32: plain FMA loops, sums in f32. Blocks on the H100
// run in parallel and in no order, so nothing depends on the order:
//
//   1. the row pass (one block per chunk of one image's rows, TM rows a
//      tile, 256 threads): recomputes the hidden 128 columns at a time in
//      shared memory as the forward does, emits dn and dx, writes ag and
//      dg1 to scratch in device memory, and adds the block's own partial
//      sums of dg1, g, dn and dn * (h - mean) into its own row of a
//      partial buffer (no atomics: each block owns its row);
//   2. the weight pass: dW1, dW2 and dWs as transposed products over the
//      rows, each split over row chunks into f32 partials, 64 x 64 output
//      tiles, 64 rows a step through shared memory;
//   3. a fixed-order reduce of every partial buffer into its output.
//
// Every sum is taken in one fixed order, so runs repeat bit for bit.
// Shared memory: the (TM x Cp) dn accumulator and the tiles grow with C,
// so the wrapper picks TM = 32 where the tile fits 227 KB and TM = 16
// where it does not (c5 and uc1; kernels/block_core.py::bwd_smem_bytes
// mirrors row_smem_bytes here), and raises past that.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int NWARPS = 8;
constexpr int NTHREADS = NWARPS * 32;
constexpr int FPAD = 4;  // floats of padding per shared row (16 bytes)
constexpr int TILE = 64;  // weight pass: output tile edge and rows per step
constexpr int TARGET_BLOCKS = 528;  // 4 per SM of the H100's 132

// C (TM x N, f32, shared, ldc) = [C +] A (TM x K, shared, lda) @ op(B),
// op(B) = B (K x N row-major, ldb) or, TRANS_B, the transpose of a
// row-major (N x K) B. K and N are multiples of 16.
template <int TM, bool TRANS_B>
__device__ void gemm_tile(const float* A, int lda, const float* B, int ldb, int K, int N,
                          float* C, int ldc, bool accumulate) {
  for (int i = threadIdx.x; i < TM * N; i += NTHREADS) {
    const int r = i / N, n = i % N;
    const float* a = A + r * lda;
    float s = accumulate ? C[r * ldc + n] : 0.0f;
    for (int k = 0; k < K; ++k)
      s = fmaf(a[k], TRANS_B ? B[(size_t)n * ldb + k] : B[(size_t)k * ldb + n], s);
    C[r * ldc + n] = s;
  }
}

struct Args {
  const float *ha, *hb, *xa, *xb, *g;
  const float *mean_a, *rsig_a, *mean_b, *rsig_b;
  const float *w1, *b1, *w2, *ws;  // packed
  float *dna, *dnb, *dxa, *dxb;
  float *dw1, *db1, *dw2, *db2, *dws, *s1a, *s2a, *s1b, *s2b;
  int B, HW, C1, C2, C1p, Cp, H4, H4p, HC, P, Pp;
};

// ---------------------------------------------------------------- row pass

struct RowPass {
  Args a;
  float* ag;     // (M, H4p) scratch
  float* dg;     // (M, H4p) scratch
  float* part;   // (nblk, RS) f32: [db1 H4p | db2 Pp | S1 Cp | S2 Cp]
  int nch, tpc;  // chunks per image, tiles per chunk
};

__host__ __device__ inline int part_stride(const Args& a) { return a.H4p + a.Pp + 2 * a.Cp; }

// Shared memory of one row-pass block, in bytes: the dn accumulator, the
// hidden and da chunks, the normalized input and the cotangent tile; every
// row padded by 16 bytes. kernels/block_core.py::bwd_smem_bytes mirrors
// this.
size_t row_smem_bytes(int tm, const Args& a) {
  return sizeof(float) * tm * ((a.Cp + FPAD) + 2 * (a.HC + FPAD) + (a.Cp + FPAD) + (a.Pp + FPAD));
}

__device__ __forceinline__ float gelu_tanh_parts(float v, float* dgelu) {
  const float k0 = 0.7978845608028654f;  // sqrt(2 / pi)
  const float k1 = 0.044715f;
  // one tanh for the value and the derivative, as the TPU kernel
  const float th = tanhf(k0 * (v + k1 * v * v * v));
  *dgelu = 0.5f * (1.0f + th) + 0.5f * v * (1.0f - th * th) * (k0 * (1.0f + 3.0f * k1 * v * v));
  return 0.5f * v * (1.0f + th);
}

__device__ __forceinline__ float gelu_erf_parts(float v, float* dgelu) {
  const float cdf = 0.5f * (1.0f + erff(v * 0.7071067811865476f));
  *dgelu = cdf + v * 0.3989422804014327f * expf(-0.5f * v * v);  // Phi + v phi
  return v * cdf;
}

template <int TM, bool TANH>
__global__ void __launch_bounds__(NTHREADS) bwd_rows_kernel(RowPass rp) {
  const Args& a = rp.a;
  const int ld_acc = a.Cp + FPAD, ld_hid = a.HC + FPAD;
  const int ld_in = a.Cp + FPAD, ld_g = a.Pp + FPAD;
  extern __shared__ __align__(128) unsigned char smem[];
  float* acc_s = reinterpret_cast<float*>(smem);  // TM x Cp: dx, then dn
  float* hid_s = acc_s + TM * ld_acc;              // TM x HC: h1
  float* da_s = hid_s + TM * ld_hid;               // TM x HC: da, then dg1
  float* in_s = da_s + TM * ld_hid;                // TM x Cp: a
  float* g_s = in_s + TM * ld_in;                  // TM x Pp: g

  const float *ha = a.ha, *hb = a.hb, *gp = a.g, *w1 = a.w1, *b1 = a.b1, *w2 = a.w2, *ws = a.ws;
  float* ag_scr = rp.ag;
  float* dg_scr = rp.dg;

  const int img = blockIdx.x / rp.nch, chunk = blockIdx.x % rp.nch;
  const int tiles = (a.HW + TM - 1) / TM;
  const int t_end = min(tiles, (chunk + 1) * rp.tpc);
  float* part = rp.part + (size_t)blockIdx.x * part_stride(a);
  float* p_db1 = part;
  float* p_db2 = part + a.H4p;
  float* p_s1 = p_db2 + a.Pp;
  float* p_s2 = p_s1 + a.Cp;
  for (int i = threadIdx.x; i < part_stride(a); i += NTHREADS) part[i] = 0.0f;
  __syncthreads();

  for (int t = chunk * rp.tpc; t < t_end; ++t) {
    const int p0 = t * TM;
    const int nrows = min(TM, a.HW - p0);
    const long long row0 = (long long)img * a.HW + p0;

    // normalized input (parts side by side); cotangent tile
    for (int i = threadIdx.x; i < TM * a.Cp; i += NTHREADS) {
      const int r = i / a.Cp, c = i % a.Cp;
      float v = 0.0f;
      if (r < nrows) {
        const long long row = row0 + r;
        if (c < a.C1) {
          const int s = img * a.C1 + c;
          v = (ha[row * a.C1 + c] - a.mean_a[s]) * a.rsig_a[s];
        } else if (c >= a.C1p && c < a.C1p + a.C2) {
          const int cb = c - a.C1p, s = img * a.C2 + cb;
          v = (hb[row * a.C2 + cb] - a.mean_b[s]) * a.rsig_b[s];
        }
      }
      in_s[r * ld_in + c] = v;
    }
    for (int i = threadIdx.x; i < TM * a.Pp; i += NTHREADS) {
      const int r = i / a.Pp, n = i % a.Pp;
      g_s[r * ld_g + n] = (r < nrows && n < a.P) ? gp[(row0 + r) * a.P + n] : 0.0f;
    }
    __syncthreads();

    // shortcut branch: dx = g @ Ws^T; db2 += column sums of g
    gemm_tile<TM, true>(g_s, ld_g, ws, a.Pp, a.Pp, a.Cp, acc_s, ld_acc, false);
    for (int n = threadIdx.x; n < a.P; n += NTHREADS) {
      float s = 0.0f;
      for (int r = 0; r < nrows; ++r) s += g_s[r * ld_g + n];
      p_db2[n] += s;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < TM * a.Cp; i += NTHREADS) {
      const int r = i / a.Cp, c = i % a.Cp;
      if (r >= nrows) continue;
      const long long row = row0 + r;
      const float v = acc_s[r * ld_acc + c];
      if (c < a.C1)
        a.dxa[row * a.C1 + c] = v;
      else if (c >= a.C1p && c < a.C1p + a.C2)
        a.dxb[row * a.C2 + (c - a.C1p)] = v;
    }

    for (int j0 = 0; j0 < a.H4p; j0 += a.HC) {
      // h1 = a @ W1[:, chunk] and da = g @ W2[chunk, :]^T, both f32
      gemm_tile<TM, false>(in_s, ld_in, w1 + j0, a.H4p, a.Cp, a.HC, hid_s, ld_hid, false);
      gemm_tile<TM, true>(g_s, ld_g, w2 + (size_t)j0 * a.Pp, a.Pp, a.Pp, a.HC, da_s, ld_hid, false);
      __syncthreads();
      for (int i = threadIdx.x; i < TM * a.HC; i += NTHREADS) {
        const int r = i / a.HC, c = i % a.HC;
        const float v = hid_s[r * ld_hid + c] + b1[j0 + c];
        float dgelu;
        const float act = TANH ? gelu_tanh_parts(v, &dgelu) : gelu_erf_parts(v, &dgelu);
        // rows past the image end have g = 0, hence dg1 = 0
        const float dg1 = da_s[r * ld_hid + c] * dgelu;
        da_s[r * ld_hid + c] = dg1;
        if (r < nrows) {
          const size_t o = (size_t)(row0 + r) * a.H4p + j0 + c;
          ag_scr[o] = act;
          dg_scr[o] = dg1;
        }
      }
      __syncthreads();
      for (int c = threadIdx.x; c < a.HC; c += NTHREADS) {
        float s = 0.0f;
        for (int r = 0; r < nrows; ++r) s += da_s[r * ld_hid + c];
        p_db1[j0 + c] += s;
      }
      // dn (+)= dg1 @ W1[:, chunk]^T
      gemm_tile<TM, true>(da_s, ld_hid, w1 + j0, a.H4p, a.HC, a.Cp, acc_s, ld_acc, j0 > 0);
      __syncthreads();
    }

    // dn out, rounded once; S1, S2 from the f32 dn
    for (int i = threadIdx.x; i < TM * a.Cp; i += NTHREADS) {
      const int r = i / a.Cp, c = i % a.Cp;
      if (r >= nrows) continue;
      const long long row = row0 + r;
      const float v = acc_s[r * ld_acc + c];
      if (c < a.C1)
        a.dna[row * a.C1 + c] = v;
      else if (c >= a.C1p && c < a.C1p + a.C2)
        a.dnb[row * a.C2 + (c - a.C1p)] = v;
    }
    for (int c = threadIdx.x; c < a.Cp; c += NTHREADS) {
      const float* h;
      int cc, cw;
      float mean;
      if (c < a.C1) {
        h = ha, cc = c, cw = a.C1, mean = a.mean_a[img * a.C1 + c];
      } else if (c >= a.C1p && c < a.C1p + a.C2) {
        h = hb, cc = c - a.C1p, cw = a.C2, mean = a.mean_b[img * a.C2 + cc];
      } else {
        continue;
      }
      float s1 = 0.0f, s2 = 0.0f;
      for (int r = 0; r < nrows; ++r) {
        const float dn = acc_s[r * ld_acc + c];
        s1 += dn;
        s2 += dn * (h[(row0 + r) * cw + cc] - mean);
      }
      p_s1[c] += s1;
      p_s2[c] += s2;
    }
    __syncthreads();
  }
}

// ------------------------------------------------------------- weight pass

// One operand of a transposed product: rows of a (M, ld) matrix, columns
// [0, ncols); with mean given, the normalized input (v - mean) * rsig with
// (image, column) statistics.
struct Src {
  const float* p;
  int ld, ncols;
  const float *mean, *rsig;
};

struct TnArgs {
  Src a, b;
  float* part;  // (R, nsplit, N) f32
  long long M, rps;  // rows, rows per split
  int HW, R, N, nsplit;
};

__device__ void load_step(float* dst, int ld, const Src& s, long long m0, long long m1, int c0,
                          int HW) {
  for (int i = threadIdx.x; i < TILE * TILE; i += NTHREADS) {
    const int mm = i / TILE, cc = i % TILE;
    const long long m = m0 + mm;
    const int c = c0 + cc;
    float v = 0.0f;
    if (m < m1 && c < s.ncols) {
      v = s.p[m * s.ld + c];
      if (s.mean) {
        const long long st = (m / HW) * s.ncols + c;
        v = (v - s.mean[st]) * s.rsig[st];
      }
    }
    dst[mm * ld + cc] = v;
  }
}

// part[r, split, n] = sum over the split's rows m of A[m, r] * B[m, n],
// for one 64 x 64 tile of (r, n).
__global__ void __launch_bounds__(NTHREADS) bwd_weights_kernel(TnArgs t) {
  constexpr int LD = TILE + FPAD;
  __shared__ __align__(128) float a_s[TILE * LD];
  __shared__ __align__(128) float b_s[TILE * LD];

  const int tiles_n = (t.N + TILE - 1) / TILE;
  const int r0 = blockIdx.x / tiles_n * TILE, n0 = blockIdx.x % tiles_n * TILE;
  const int split = blockIdx.y;
  const long long m_begin = (long long)split * t.rps;
  const long long m_end = min(t.M, m_begin + t.rps);

  // each thread: column n = tid % 64, rows tid / 64 + 4q
  const int n = threadIdx.x % TILE, rb = threadIdx.x / TILE;
  float acc[TILE / 4];
#pragma unroll
  for (int q = 0; q < TILE / 4; ++q) acc[q] = 0.0f;
  for (long long m0 = m_begin; m0 < m_end; m0 += TILE) {
    load_step(a_s, LD, t.a, m0, m_end, r0, t.HW);
    load_step(b_s, LD, t.b, m0, m_end, n0, t.HW);
    __syncthreads();
    for (int mm = 0; mm < TILE; ++mm) {
      const float bv = b_s[mm * LD + n];
#pragma unroll
      for (int q = 0; q < TILE / 4; ++q) acc[q] = fmaf(a_s[mm * LD + rb + 4 * q], bv, acc[q]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int q = 0; q < TILE / 4; ++q) {
    const int r = r0 + rb + 4 * q, nn = n0 + n;
    if (r < t.R && nn < t.N) t.part[((size_t)r * t.nsplit + split) * t.N + nn] = acc[q];
  }
}

// out[g * out_ld + i] = sum over s < S, in order, of in[(g * S + s) * in_ld + off + i]
__global__ void bwd_reduce_kernel(const float* in, int S, int in_ld, int off, int L, float* out,
                              int out_ld) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int g = blockIdx.y;
  if (i >= L) return;
  const float* p = in + (size_t)g * S * in_ld + off + i;
  float s = 0.0f;
  for (int k = 0; k < S; ++k) s += p[(size_t)k * in_ld];
  out[(size_t)g * out_ld + i] = s;
}

// ------------------------------------------------------------------- plan

struct Job {
  Src a, b;
  float* out;  // (R, N) rows of the output, row stride N
  int R, N, nsplit;
  long long rps;
  size_t off;  // partials' offset in the workspace
};

struct Plan {
  int nch, tpc, nblk;
  size_t off_ag, off_dg, off_part, total;
  Job jobs[5];
  int njobs;
};

size_t align256(size_t n) { return (n + 255) / 256 * 256; }

// The row pass's grid, the splits of each transposed product, and where
// each buffer sits in the workspace (ws null: only the size is wanted).
Plan make_plan(const Args& a, int tm, unsigned char* ws) {
  Plan pl{};
  const long long M = (long long)a.B * a.HW;
  const int tiles = (a.HW + tm - 1) / tm;
  int nch = (TARGET_BLOCKS + a.B - 1) / a.B;
  nch = nch < 1 ? 1 : (nch > tiles ? tiles : nch);
  pl.tpc = (tiles + nch - 1) / nch;
  pl.nch = (tiles + pl.tpc - 1) / pl.tpc;
  pl.nblk = a.B * pl.nch;
  size_t off = 0;
  pl.off_ag = off;
  off = align256(off + (size_t)M * a.H4p * sizeof(float));
  pl.off_dg = off;
  off = align256(off + (size_t)M * a.H4p * sizeof(float));
  pl.off_part = off;
  off = align256(off + sizeof(float) * (size_t)pl.nblk * part_stride(a));

  const Src g{a.g, a.P, a.P, nullptr, nullptr};
  auto scratch = [&](size_t at) {
    return ws ? reinterpret_cast<const float*>(ws + at) : nullptr;
  };
  const Src ag{scratch(pl.off_ag), a.H4p, a.H4, nullptr, nullptr};
  const Src dg{scratch(pl.off_dg), a.H4p, a.H4, nullptr, nullptr};
  int n = 0;
  // dW1 = a^T dg1, dW2 = ag^T g, dWs = x^T g; each part of the
  // two-input form into its own rows of the concat layout
  pl.jobs[n++] = Job{Src{a.ha, a.C1, a.C1, a.mean_a, a.rsig_a}, dg, a.dw1, a.C1, a.H4};
  if (a.C2)
    pl.jobs[n++] = Job{Src{a.hb, a.C2, a.C2, a.mean_b, a.rsig_b}, dg,
                       a.dw1 + (size_t)a.C1 * a.H4, a.C2, a.H4};
  pl.jobs[n++] = Job{ag, g, a.dw2, a.H4, a.P};
  pl.jobs[n++] = Job{Src{a.xa, a.C1, a.C1, nullptr, nullptr}, g, a.dws, a.C1, a.P};
  if (a.C2)
    pl.jobs[n++] = Job{Src{a.xb, a.C2, a.C2, nullptr, nullptr}, g, a.dws + (size_t)a.C1 * a.P,
                       a.C2, a.P};
  pl.njobs = n;
  for (int j = 0; j < n; ++j) {
    Job& jb = pl.jobs[j];
    const long long tiles_out = (long long)((jb.R + TILE - 1) / TILE) * ((jb.N + TILE - 1) / TILE);
    long long ns = (TARGET_BLOCKS + tiles_out - 1) / tiles_out;
    const long long most = (M + 1023) / 1024;  // at least ~1024 rows a split
    ns = ns > most ? most : ns;
    ns = ns < 1 ? 1 : ns;
    jb.rps = ((M + ns - 1) / ns + TILE - 1) / TILE * TILE;
    jb.nsplit = (int)((M + jb.rps - 1) / jb.rps);
    jb.off = off;
    off = align256(off + sizeof(float) * (size_t)jb.R * jb.nsplit * jb.N);
  }
  pl.total = off;
  return pl;
}

int reduce(const float* in, int S, int in_ld, int off, int G, int L, float* out, int out_ld,
           cudaStream_t s) {
  if (G == 0 || L == 0) return 0;
  dim3 grid((L + 255) / 256, G);
  bwd_reduce_kernel<<<grid, 256, 0, s>>>(in, S, in_ld, off, L, out, out_ld);
  return (int)cudaGetLastError();
}

template <int TM, bool TANH>
int run_typed(const Args& a, unsigned char* ws, cudaStream_t s) {
  Plan pl = make_plan(a, TM, ws);
  RowPass rp{a, reinterpret_cast<float*>(ws + pl.off_ag), reinterpret_cast<float*>(ws + pl.off_dg),
             reinterpret_cast<float*>(ws + pl.off_part), pl.nch, pl.tpc};
  const size_t smem = row_smem_bytes(TM, a);
  cudaError_t err = cudaFuncSetAttribute(bwd_rows_kernel<TM, TANH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  bwd_rows_kernel<TM, TANH><<<pl.nblk, NTHREADS, smem, s>>>(rp);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  const long long M = (long long)a.B * a.HW;
  for (int j = 0; j < pl.njobs; ++j) {
    const Job& jb = pl.jobs[j];
    TnArgs t{jb.a, jb.b, reinterpret_cast<float*>(ws + jb.off), M, jb.rps, a.HW, jb.R, jb.N,
             jb.nsplit};
    dim3 grid(((jb.R + TILE - 1) / TILE) * ((jb.N + TILE - 1) / TILE), jb.nsplit);
    bwd_weights_kernel<<<grid, NTHREADS, 0, s>>>(t);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    int e = reduce(t.part, jb.nsplit, jb.N, 0, jb.R, jb.N, jb.out, jb.N, s);
    if (e) return e;
  }

  // db1, db2 over every block; S1, S2 per image over its chunks
  const float* part = rp.part;
  const int RS = part_stride(a), so = a.H4p + a.Pp;
  int e = 0;
  if (!e) e = reduce(part, pl.nblk, RS, 0, 1, a.H4, a.db1, a.H4, s);
  if (!e) e = reduce(part, pl.nblk, RS, a.H4p, 1, a.P, a.db2, a.P, s);
  if (!e) e = reduce(part, pl.nch, RS, so, a.B, a.C1, a.s1a, a.C1, s);
  if (!e) e = reduce(part, pl.nch, RS, so + a.Cp, a.B, a.C1, a.s2a, a.C1, s);
  if (!e && a.C2) e = reduce(part, pl.nch, RS, so + a.C1p, a.B, a.C2, a.s1b, a.C2, s);
  if (!e && a.C2) e = reduce(part, pl.nch, RS, so + a.Cp + a.C1p, a.B, a.C2, a.s2b, a.C2, s);
  return e;
}

int run(int bf16_storage, int tanh_gelu, int tm, const Args& a, void* workspace,
        unsigned long long* workspace_bytes, void* stream) {
  if (bf16_storage) return (int)cudaErrorNotSupported;  // block_core2_bwd_sm90.cu
  if (workspace == nullptr) {
    *workspace_bytes = make_plan(a, tm, nullptr).total;
    return 0;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  unsigned char* ws = static_cast<unsigned char*>(workspace);
  if (tm == 32) return tanh_gelu ? run_typed<32, true>(a, ws, s) : run_typed<32, false>(a, ws, s);
  if (tm == 16) return tanh_gelu ? run_typed<16, true>(a, ws, s) : run_typed<16, false>(a, ws, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// K2 and K4 in f32 (bf16_storage must be 0) share one entry: hb, xb,
// mean_b, rsig_b, dnb, dxb, s1b and s2b are null and C2 = 0 for the
// one-input form. With workspace null it only
// writes the workspace's size in bytes to *workspace_bytes; otherwise it
// launches every pass on the stream and returns cudaGetLastError() of the
// first launch that failed, or 0.
int block_core_bwd(int bf16_storage, int tanh_gelu, int tm, const void* ha, const void* hb,
                   const void* xa, const void* xb, const void* g, const float* mean_a,
                   const float* rsig_a, const float* mean_b, const float* rsig_b, const void* w1,
                   const void* b1, const void* w2, const void* ws, void* dna, void* dnb,
                   void* dxa, void* dxb, float* dw1, float* db1, float* dw2, float* db2,
                   float* dws, float* s1a, float* s2a, float* s1b, float* s2b, int B, int HW,
                   int C1, int C2, int C1p, int Cp, int H4, int H4p, int HC, int P, int Pp,
                   void* workspace, unsigned long long* workspace_bytes, void* stream) {
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto m = [](void* p) { return static_cast<float*>(p); };
  Args a{f(ha),   f(hb),   f(xa),   f(xb), f(g),  mean_a, rsig_a, mean_b, rsig_b,
         f(w1),   f(b1),   f(w2),   f(ws), m(dna), m(dnb), m(dxa), m(dxb), dw1,
         db1,     dw2,     db2,     dws,   s1a,   s2a,    s1b,    s2b,    B,
         HW,      C1,      C2,      C1p,   Cp,    H4,     H4p,    HC,     P,
         Pp};
  return run(bf16_storage, tanh_gelu, tm, a, workspace, workspace_bytes, stream);
}

}  // extern "C"
