// Fused ConvNeXt block core, forward, f32 check build: InstanceNorm-apply
// -> Linear(4C) -> GELU -> Linear(P) -> + 1x1 shortcut, for NVIDIA Hopper
// (sm_90a).
//
// Replaces the TPU kernels of dsgan_tpu/pallas/block_core.py in f32:
//   K1  _fwd_kernel  / _fwd_impl   (one input:  block_core_fwd)
//   K3  _fwd_kernel2 / _fwd2_impl  (two inputs: block_core2_fwd)
// The bf16 forms of both run on the tensor cores in
// block_core2_fwd_sm90.cu; these entries refuse bf16 (cudaErrorNotSupported).
//
// Per pixel row r of the NHWC activations flattened to (M, C):
//
//   out[r] = gelu((h[r] - mean[b]) * rsig[b] @ W1 + b1) @ W2 + b2 + x[r] @ Ws
//
// The two-input form takes h and x as two channel parts (the decoder's
// upsampled tensor and its skip), laid side by side in shared memory, so
// the K-split GEMMs over [W1a; W1b] and [Wsa; Wsb] are one GEMM over the
// packed weight.
//
// It exists to hold the structure of the bf16 kernels (the packed, per-part
// padded weights, the parts side by side, the 4C-wide hidden made HC
// columns at a time and never written to device memory) tightly against
// the plain PyTorch version in f32, where a bf16 comparison would hide
// faults in rounding: plain FMA loops, sums in f32. A block of 256 threads
// owns TM = 32 rows; the hidden chunk and the (TM x P) accumulator live in
// shared memory, every row padded by 16 bytes. Speed is not its purpose:
// f32 has no use on the main path.
//
// Weights come packed by the wrapper (kernels/block_core.py): row-major,
// (K, N) orientation, zero-padded to multiples of 16 in both dimensions,
// the two input parts each padded on their own. Activations need no
// alignment: rows are read element by element, so C = 3 works.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int TM = 32;  // rows per block
constexpr int NWARPS = 8;
constexpr int NTHREADS = NWARPS * 32;
constexpr int FPAD = 4;  // floats of padding per shared row (16 bytes)

__device__ __forceinline__ float gelu_tanh(float v) {
  const float k0 = 0.7978845608028654f;  // sqrt(2 / pi)
  const float k1 = 0.044715f;
  return 0.5f * v * (1.0f + tanhf(k0 * (v + k1 * v * v * v)));
}

__device__ __forceinline__ float gelu_erf(float v) {
  return 0.5f * v * (1.0f + erff(v * 0.7071067811865476f));
}

// C (TM x N, f32, shared, ldc) = [C +] A (TM x K, shared, lda) @ B (K x N,
// global, ldb). K and N are multiples of 16.
__device__ void gemm_tile(const float* A, int lda, const float* B, int ldb, int K, int N,
                          float* C, int ldc, bool accumulate) {
  for (int i = threadIdx.x; i < TM * N; i += NTHREADS) {
    const int r = i / N, n = i % N;
    const float* a = A + r * lda;
    float s = accumulate ? C[r * ldc + n] : 0.0f;
    for (int k = 0; k < K; ++k) s = fmaf(a[k], B[(size_t)k * ldb + n], s);
    C[r * ldc + n] = s;
  }
}

struct Args {
  const float *ha, *hb, *xa, *xb;
  const float *mean_a, *rsig_a, *mean_b, *rsig_b;
  const float *w1, *b1, *w2, *b2, *ws;
  float* out;
  long long M;  // rows: batch * HW
  int HW, C1, C2, C1p, Cp, H4p, HC, P, Pp;
};

// Shared memory of one block, in bytes: the accumulator, the hidden chunk
// and the input tile. kernels/block_core.py::smem_bytes mirrors this.
size_t smem_bytes(const Args& a) {
  return sizeof(float) * TM * (a.Pp + FPAD + a.HC + FPAD + a.Cp + FPAD);
}

// Fill in_s (TM x Cp, row stride ld) with the row tile of parts (pa, pb),
// normalized with per-(image, channel) stats when mean_a is given; zero
// the padding channels.
__device__ void load_rows(float* in_s, int ld, const Args& a, long long row0, const float* pa,
                          const float* pb, const float* mean_a, const float* rsig_a,
                          const float* mean_b, const float* rsig_b) {
  for (int i = threadIdx.x; i < TM * a.Cp; i += NTHREADS) {
    const int r = i / a.Cp, c = i % a.Cp;
    const long long row = row0 + r;
    float v = 0.0f;
    if (row < a.M) {
      const long long img = row / a.HW;
      if (c < a.C1) {
        v = pa[row * a.C1 + c];
        if (mean_a) v = (v - mean_a[img * a.C1 + c]) * rsig_a[img * a.C1 + c];
      } else if (c >= a.C1p && c < a.C1p + a.C2) {
        const int cb = c - a.C1p;
        v = pb[row * a.C2 + cb];
        if (mean_b) v = (v - mean_b[img * a.C2 + cb]) * rsig_b[img * a.C2 + cb];
      }
    }
    in_s[r * ld + c] = v;
  }
}

template <bool TANH>
__global__ void __launch_bounds__(NTHREADS) block_core_kernel(Args a) {
  const int ld_acc = a.Pp + FPAD, ld_hid = a.HC + FPAD, ld_in = a.Cp + FPAD;
  extern __shared__ __align__(128) unsigned char smem[];
  float* acc_s = reinterpret_cast<float*>(smem);  // TM x Pp
  float* hid_s = acc_s + TM * ld_acc;              // TM x HC: the hidden, then its GELU
  float* in_s = hid_s + TM * ld_hid;               // TM x Cp

  const long long row0 = (long long)blockIdx.x * TM;

  // shortcut: acc = x @ Ws + b2
  load_rows(in_s, ld_in, a, row0, a.xa, a.xb, nullptr, nullptr, nullptr, nullptr);
  for (int i = threadIdx.x; i < TM * a.Pp; i += NTHREADS) {
    const int r = i / a.Pp, n = i % a.Pp;
    acc_s[r * ld_acc + n] = n < a.P ? a.b2[n] : 0.0f;
  }
  __syncthreads();
  gemm_tile(in_s, ld_in, a.ws, a.Pp, a.Cp, a.Pp, acc_s, ld_acc, true);
  __syncthreads();

  // normalized input
  load_rows(in_s, ld_in, a, row0, a.ha, a.hb, a.mean_a, a.rsig_a, a.mean_b, a.rsig_b);
  __syncthreads();

  for (int j0 = 0; j0 < a.H4p; j0 += a.HC) {
    gemm_tile(in_s, ld_in, a.w1 + j0, a.H4p, a.Cp, a.HC, hid_s, ld_hid, false);
    __syncthreads();
    for (int i = threadIdx.x; i < TM * a.HC; i += NTHREADS) {
      const int r = i / a.HC, c = i % a.HC;
      const float v = hid_s[r * ld_hid + c] + a.b1[j0 + c];
      hid_s[r * ld_hid + c] = TANH ? gelu_tanh(v) : gelu_erf(v);
    }
    __syncthreads();
    gemm_tile(hid_s, ld_hid, a.w2 + (size_t)j0 * a.Pp, a.Pp, a.HC, a.Pp, acc_s, ld_acc, true);
    __syncthreads();
  }

  for (int i = threadIdx.x; i < TM * a.P; i += NTHREADS) {
    const int r = i / a.P, n = i % a.P;
    const long long row = row0 + r;
    if (row < a.M) a.out[row * a.P + n] = acc_s[r * ld_acc + n];
  }
}

int launch(int bf16_storage, int tanh_gelu, const Args& a, void* stream) {
  if (bf16_storage) return (int)cudaErrorNotSupported;  // block_core2_fwd_sm90.cu
  auto kernel = tanh_gelu ? block_core_kernel<true> : block_core_kernel<false>;
  const size_t smem = smem_bytes(a);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (a.M + TM - 1) / TM;
  kernel<<<(unsigned)blocks, NTHREADS, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// K1 in f32 (bf16_storage must be 0). h, x: (M, C) rows; mean, rsig: (B,
// C) f32. Returns cudaGetLastError() after the launch.
int block_core_fwd(int bf16_storage, int tanh_gelu, const void* h, const void* x,
                   const float* mean, const float* rsig, const void* w1, const void* b1,
                   const void* w2, const void* b2, const void* ws, void* out, long long M,
                   int HW, int C, int Cp, int H4p, int HC, int P, int Pp, void* stream) {
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  Args a{f(h), nullptr, f(x), nullptr, mean, rsig, nullptr, nullptr, f(w1), f(b1), f(w2), f(b2),
         f(ws), static_cast<float*>(out), M, HW, C, 0, Cp, Cp, H4p, HC, P, Pp};
  return launch(bf16_storage, tanh_gelu, a, stream);
}

// K3 in f32. Parts a (C1 channels) and b (C2 channels); the packed weights
// hold part a in rows [0, C1) and part b in rows [C1p, C1p + C2).
int block_core2_fwd(int bf16_storage, int tanh_gelu, const void* ha, const void* hb,
                    const void* xa, const void* xb, const float* mean_a, const float* rsig_a,
                    const float* mean_b, const float* rsig_b, const void* w1, const void* b1,
                    const void* w2, const void* b2, const void* ws, void* out, long long M,
                    int HW, int C1, int C2, int C1p, int Cp, int H4p, int HC, int P, int Pp,
                    void* stream) {
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  Args a{f(ha), f(hb), f(xa), f(xb), mean_a, rsig_a, mean_b, rsig_b, f(w1), f(b1), f(w2), f(b2),
         f(ws), static_cast<float*>(out), M, HW, C1, C2, C1p, Cp, H4p, HC, P, Pp};
  return launch(bf16_storage, tanh_gelu, a, stream);
}

}  // extern "C"
