// The federated round's kernels for Hopper: the batched sample-
// reconstruct forward, the transpose-plan backward and the upload
// sample-pack.  Device functions (hash, Q-row regeneration, mask draw,
// quantized threshold, Box-Muller) come from qz_common.cuh, the code
// the serve kernel (qz_decode.cu) already holds bitwise against torch.
//
// sample_reconstruct_kernel replaces qz_sample_reconstruct_batched_fwd
// and, at K = 1, qz_sample_reconstruct_fwd (src/repro/kernels/
// qz_reconstruct.py).  W[k, r] = sum_j vals[r, j] * z_k[idx[r, j]] with
// z_k ~ Bern(p_k) drawn in the body from the hash stream at the edge's
// coordinate (f32 probabilities, or the u8/u16 threshold compare).  One
// thread owns one row: it regenerates the row's d edges (coordinates
// and values) once into shared memory, then for each of the K clients
// gathers that client's draw at each edge and sums vals * bit in
// ascending j, each multiply and add rounded on its own.  The Pallas
// kernel selects window bits by a one-hot MXU product; here the draw is
// read by gather.  Only the valid rows [0, m) of the single-block
// layout are computed (the padding rows the JAX wrapper slices off are
// never formed).
// Bound: bytes at MNISTFC width.  The least work is per row 2 row
// hashes, per edge 2 value hashes and a Box-Muller, one mask hash and
// a compare per (client, coordinate) (this kernel redraws per (client,
// edge), d*m/n = 80 times that at compression 8, d = 10), an add per
// drawn edge; against the K operand rows read and K output rows written.
//
// plan_bwd_kernel replaces qz_reconstruct_batched_bwd_plan.  It reads
// the global (num_windows, window, deg) transpose plan directly (no
// per-row-block re-binning as the Pallas grid needs): one thread per
// (coordinate, client) sums vals[c, e] * g_k[w*rpw + rows[c, e]] over e
// in ascending order, the canonical plan order, each multiply and add
// rounded on its own.  Padding entries (value 0) add exact zeros.
// Bound: bytes (the plan's rows and values dominate).
//
// sample_pack_kernel replaces qz_sample_pack_batched_fwd.  One thread
// per (lane, client) draws the lane's 32 coordinates and ORs bit j into
// position j: comm.bitpack.pack_mask's layout.  Lanes are written as
// int64 holding the uint32 value, the port's carrier for 32-bit words.
// Bound: bytes (4 bytes of probability in per bit out).
//
// Draw words arrive as the port carries them: int64 holding the uint32
// value.  Every launch function returns the launch's cudaError_t.

#include <cuda_runtime.h>

#include <cstdint>

#include "qz_common.cuh"

namespace {

constexpr int THREADS = 128;

template <int KIND>
__device__ __forceinline__ const void* client_words(const void* P, int k,
                                                    long long n) {
  const long long off = static_cast<long long>(k) * n;
  if (KIND == qz::KIND_F32) return static_cast<const float*>(P) + off;
  if (KIND == qz::KIND_U8) return static_cast<const uint8_t*>(P) + off;
  return static_cast<const uint16_t*>(P) + off;
}

template <int KIND>
__global__ void __launch_bounds__(THREADS)
sample_reconstruct_kernel(const void* __restrict__ P, int qbits,
                          const long long* __restrict__ steps, int K,
                          long long n, uint32_t m, qz::SpecArgs s,
                          float* __restrict__ W) {
  extern __shared__ uint32_t smem[];
  uint32_t* sHm = smem;                          // K mask prefixes
  uint32_t* sCoord = sHm + K;                    // d x THREADS coordinates
  float* sVal = reinterpret_cast<float*>(sCoord + s.d * THREADS);  // values

  const int t = threadIdx.x;
  for (int k = t; k < K; k += THREADS) {
    sHm[k] = qz::mask_prefix(s.seed, s.tensor_id, static_cast<uint32_t>(steps[k]));
  }
  const uint32_t r = blockIdx.x * THREADS + t;
  if (r < m) {
    const uint32_t hq = qz::prefix2(s.seed, s.tensor_id);
    const qz::RowEdges e = qz::row_edges(hq, r, s.window);
    const uint32_t wbase = (r / s.rows_per_window) * s.window;
    for (int j = 0; j < s.d; ++j) {
      sCoord[j * THREADS + t] = wbase + e.index(j, s.window);
      sVal[j * THREADS + t] = e.value(j, s.sigma);
    }
  }
  __syncthreads();
  if (r >= m) return;
  for (int k = 0; k < K; ++k) {
    const void* words = client_words<KIND>(P, k, n);
    const uint32_t hm = sHm[k];
    float acc = 0.0f;
    for (int j = 0; j < s.d; ++j) {
      const float bit = qz::mask_bit<KIND>(words, qbits, hm, sCoord[j * THREADS + t]) ? 1.0f : 0.0f;
      const float prod = __fmul_rn(sVal[j * THREADS + t], bit);
      acc = (j == 0) ? prod : __fadd_rn(acc, prod);
    }
    W[static_cast<long long>(k) * m + r] = acc;
  }
}

__global__ void __launch_bounds__(THREADS)
plan_bwd_kernel(const float* __restrict__ G, const int* __restrict__ rows,
                const float* __restrict__ vals, uint32_t n, uint32_t m,
                int deg, uint32_t window, uint32_t rows_per_window,
                float* __restrict__ out) {
  const uint32_t c = blockIdx.x * THREADS + threadIdx.x;
  const int k = blockIdx.y;
  if (c >= n) return;
  const long long base = static_cast<long long>(c) * deg;
  const uint32_t row0 = (c / window) * rows_per_window;
  const float* g = G + static_cast<long long>(k) * m;
  float acc = 0.0f;
  for (int e = 0; e < deg; ++e) {
    const uint32_t row = row0 + static_cast<uint32_t>(rows[base + e]);
    const float gv = row < m ? g[row] : 0.0f;  // padding rows carry 0
    const float prod = __fmul_rn(vals[base + e], gv);
    acc = (e == 0) ? prod : __fadd_rn(acc, prod);
  }
  out[static_cast<long long>(k) * n + c] = acc;
}

__global__ void __launch_bounds__(THREADS)
sample_pack_kernel(const float* __restrict__ P,
                   const long long* __restrict__ steps, long long n,
                   uint32_t lanes, qz::SpecArgs s,
                   long long* __restrict__ out) {
  const uint32_t i = blockIdx.x * THREADS + threadIdx.x;
  const int k = blockIdx.y;
  if (i >= lanes) return;
  const uint32_t hm = qz::mask_prefix(s.seed, s.tensor_id, static_cast<uint32_t>(steps[k]));
  const void* words = P + static_cast<long long>(k) * n;
  uint32_t lane = 0u;
  for (int j = 0; j < 32; ++j) {
    const uint32_t coord = i * 32u + static_cast<uint32_t>(j);
    if (coord < n && qz::mask_bit<qz::KIND_F32>(words, 0, hm, coord)) {
      lane |= 1u << j;
    }
  }
  out[static_cast<long long>(k) * lanes + i] = static_cast<long long>(lane);
}

qz::SpecArgs spec_args(unsigned seed, unsigned tensor_id, int window,
                       unsigned rows_per_window, int d, float sigma) {
  qz::SpecArgs s;
  s.seed = seed;
  s.tensor_id = tensor_id;
  s.window = static_cast<uint32_t>(window);
  s.rows_per_window = rows_per_window;
  s.d = d;
  s.sigma = sigma;
  return s;
}

}  // namespace

extern "C" {

// W (K, m) = Q Bern(P_k) for the K clients' operands P (K, n).
int qz_sample_reconstruct(const void* P, int kind, int qbits,
                          const long long* steps, int K, long long n,
                          unsigned m, unsigned seed, unsigned tensor_id,
                          int window, unsigned rows_per_window, int d,
                          float sigma, float* W, void* stream) {
  const qz::SpecArgs s = spec_args(seed, tensor_id, window, rows_per_window, d, sigma);
  const dim3 grid((m + THREADS - 1) / THREADS);
  const size_t smem = sizeof(uint32_t) * (static_cast<size_t>(K) + 2u * d * THREADS);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case qz::KIND_F32:
      sample_reconstruct_kernel<qz::KIND_F32><<<grid, THREADS, smem, st>>>(P, qbits, steps, K, n, m, s, W);
      break;
    case qz::KIND_U8:
      sample_reconstruct_kernel<qz::KIND_U8><<<grid, THREADS, smem, st>>>(P, qbits, steps, K, n, m, s, W);
      break;
    case qz::KIND_U16:
      sample_reconstruct_kernel<qz::KIND_U16><<<grid, THREADS, smem, st>>>(P, qbits, steps, K, n, m, s, W);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// out (K, n) = Q^T G_k over the transpose plan; G (K, m) moved order.
int qz_plan_bwd(const float* G, const int* rows, const float* vals, int K,
                unsigned n, unsigned m, int deg, int window,
                unsigned rows_per_window, float* out, void* stream) {
  const dim3 grid((n + THREADS - 1) / THREADS, K);
  plan_bwd_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      G, rows, vals, n, m, deg, static_cast<uint32_t>(window), rows_per_window, out);
  return static_cast<int>(cudaGetLastError());
}

// out (K, ceil(n/32)) lanes of Bern(P_k), P (K, n) f32 probabilities.
int qz_sample_pack(const float* P, const long long* steps, int K, long long n,
                   unsigned seed, unsigned tensor_id, long long* out,
                   void* stream) {
  const qz::SpecArgs s = spec_args(seed, tensor_id, 1, 1, 0, 0.0f);
  const uint32_t lanes = static_cast<uint32_t>((n + 31) / 32);
  const dim3 grid((lanes + THREADS - 1) / THREADS, K);
  sample_pack_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      P, steps, n, lanes, s, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
