// Streamed serve matmul for Hopper: Y = X @ W_g, with W_g regenerated
// from the encoded score words and never written to device memory.
//
// Replaces the Pallas kernels qz_sample_matmul / qz_sample_matvec
// (src/repro/kernels/qz_decode.py).  Per weight it regenerates the row's
// d Q edges from the counter hash, draws each edge's mask bit from the
// score word at the edge's z coordinate (f32 Bernoulli compare, or the
// u8/u16 widened-threshold integer compare) and sums vals * bits.
//
// Bound: the operations.  A weight costs 2 row hashes, d mask hashes and,
// for each drawn edge, 2 value hashes and one Box-Muller (logf, sqrtf,
// cosf); the words and activations it reads are a few bytes per weight.
// The design spreads the regeneration over all threads of a CTA and keeps
// the weights in shared memory only.
//
// Summation order (the canonical tree of src/repro_torch/kernels/ops.py):
// for output column o, input rows i ascend; the products x_i * W_io add
// into a partial sum that flushes into y_o whenever the next row of
// column o lies in another (window, bm) block, and at the last row.
// Every multiply and add is rounded on its own.  One thread owns one
// (batch row, column) pair and walks the rows in order, so the result is
// the same for any batch size and equals the plain torch path bit for bit.
//
// Layout: a CTA owns CO = 8 output columns and walks the group's d_in
// input rows in chunks of CI = 32 rows.  Its 256 threads regenerate the
// CI x CO chunk of weights into shared memory, one weight each, and with
// it each weight's flush flag; then the (batch row, column) threads
// consume the chunk in row order, a multiply, an add and a flag test per
// row, with the chunk's x rows staged in shared memory.  (All the
// divisions of the block test sit in the parallel phase: a first version
// that made the walking threads compute them took ~7 us per chunk
// whatever the width.)  The degree d = 8 of the served configs is a
// compile-time constant, so each weight's 8 edge chains overlap.

#include <cuda_runtime.h>

#include <cstdint>

#include "qz_common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int CO = 8;              // output columns per CTA
constexpr int CI = THREADS / CO;   // input rows per regenerated chunk

struct GroupArgs {
  uint32_t row_offset;  // first flat row of the group
  int d_in;
  int d_out;
  uint32_t bm;   // rows per canonical block
  uint32_t bpw;  // canonical blocks per window
};

__device__ __forceinline__ uint32_t block_of(uint32_t r, uint32_t rpw,
                                             uint32_t bm, uint32_t bpw) {
  const uint32_t win = r / rpw;
  return win * bpw + (r - win * rpw) / bm;
}

template <int KIND, int D>
__global__ void __launch_bounds__(THREADS)
serve_matmul_kernel(const void* __restrict__ words, int qbits, uint32_t step,
                    const float* __restrict__ X, float* __restrict__ Y, int B,
                    qz::SpecArgs s, GroupArgs g) {
  extern __shared__ float smem[];
  float* sW = smem;               // CI x CO weights of the current chunk
  float* sP = sW + CI * CO;       // B x CO open partial sums
  float* sY = sP + B * CO;        // B x CO accumulated outputs
  float* sX = sY + B * CO;        // B x CI activations of the chunk
  // 1 where the sum of the weight's column flushes after its row
  unsigned char* sF = reinterpret_cast<unsigned char*>(sX + B * CI);

  const int t = threadIdx.x;
  const int o0 = blockIdx.x * CO;
  const uint32_t hq = qz::prefix2(s.seed, s.tensor_id);
  const uint32_t hm = qz::mask_prefix(s.seed, s.tensor_id, step);

  for (int p = t; p < B * CO; p += THREADS) {
    sP[p] = 0.0f;
    sY[p] = 0.0f;
  }
  for (int i0 = 0; i0 < g.d_in; i0 += CI) {
    __syncthreads();  // the previous chunk has been consumed
    {
      const int ci = t / CO, co = t % CO;
      const int i = i0 + ci, o = o0 + co;
      float w = 0.0f;
      unsigned char flush = 0;
      if (i < g.d_in && o < g.d_out) {
        const uint32_t r = g.row_offset + static_cast<uint32_t>(i) * g.d_out + o;
        w = qz::edge_weight<KIND, D>(s, hq, hm, words, qbits, r);
        flush = (i == g.d_in - 1) ||
                block_of(r, s.rows_per_window, g.bm, g.bpw) !=
                    block_of(r + g.d_out, s.rows_per_window, g.bm, g.bpw);
      }
      sW[ci * CO + co] = w;
      sF[ci * CO + co] = flush;
    }
    for (int p = t; p < B * CI; p += THREADS) {
      const int b = p / CI, i = i0 + p % CI;
      sX[p] = i < g.d_in ? X[static_cast<long long>(b) * g.d_in + i] : 0.0f;
    }
    __syncthreads();
    for (int p = t; p < B * CO; p += THREADS) {
      const int b = p / CO, co = p % CO, o = o0 + co;
      if (o >= g.d_out) continue;
      float part = sP[p], acc = sY[p];
      const float* xb = sX + b * CI;
      const int iend = min(CI, g.d_in - i0);
      for (int ci = 0; ci < iend; ++ci) {
        part = __fadd_rn(part, __fmul_rn(xb[ci], sW[ci * CO + co]));
        if (sF[ci * CO + co]) {
          acc = __fadd_rn(acc, part);
          part = 0.0f;
        }
      }
      sP[p] = part;
      sY[p] = acc;
    }
  }
  __syncthreads();
  for (int p = t; p < B * CO; p += THREADS) {
    const int b = p / CO, o = o0 + p % CO;
    if (o < g.d_out) Y[static_cast<long long>(b) * g.d_out + o] = sY[p];
  }
}

// Debug view of the same device functions: per row, its d in-window
// indices, mask bits and values, and its streamed weight.
template <int KIND>
__global__ void edges_kernel(const void* __restrict__ words, int qbits,
                             uint32_t step, const long long* __restrict__ rows,
                             int R, qz::SpecArgs s, int* __restrict__ idx,
                             uint8_t* __restrict__ bits, float* __restrict__ vals,
                             float* __restrict__ w) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= R) return;
  const uint32_t hq = qz::prefix2(s.seed, s.tensor_id);
  const uint32_t hm = qz::mask_prefix(s.seed, s.tensor_id, step);
  const uint32_t r = static_cast<uint32_t>(rows[j]);
  const qz::RowEdges e = qz::row_edges(hq, r, s.window);
  const uint32_t wbase = (r / s.rows_per_window) * s.window;
  for (int k = 0; k < s.d; ++k) {
    const uint32_t ix = e.index(k, s.window);
    idx[j * s.d + k] = static_cast<int>(ix);
    bits[j * s.d + k] = qz::mask_bit<KIND>(words, qbits, hm, wbase + ix) ? 1 : 0;
    vals[j * s.d + k] = e.value(k, s.sigma);
  }
  w[j] = qz::edge_weight<KIND>(s, hq, hm, words, qbits, r);
}

template <int D>
void launch(int kind, dim3 grid, size_t smem, cudaStream_t st, const void* words,
            int qbits, uint32_t step, const float* X, float* Y, int B,
            const qz::SpecArgs& s, const GroupArgs& g) {
  if (kind == qz::KIND_F32) {
    serve_matmul_kernel<qz::KIND_F32, D><<<grid, THREADS, smem, st>>>(words, qbits, step, X, Y, B, s, g);
  } else if (kind == qz::KIND_U8) {
    serve_matmul_kernel<qz::KIND_U8, D><<<grid, THREADS, smem, st>>>(words, qbits, step, X, Y, B, s, g);
  } else {
    serve_matmul_kernel<qz::KIND_U16, D><<<grid, THREADS, smem, st>>>(words, qbits, step, X, Y, B, s, g);
  }
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

// Y (B, d_out) = X (B, d_in) @ W_g; returns the launch's cudaError_t.
int qz_serve_matmul(const void* words, int kind, int qbits, unsigned step,
                    const float* X, float* Y, int B, unsigned seed,
                    unsigned tensor_id, int window, unsigned rows_per_window,
                    int d, float sigma, unsigned row_offset, int d_in,
                    int d_out, int bm, void* stream) {
  const qz::SpecArgs s = spec_args(seed, tensor_id, window, rows_per_window, d, sigma);
  GroupArgs g;
  g.row_offset = row_offset;
  g.d_in = d_in;
  g.d_out = d_out;
  g.bm = static_cast<uint32_t>(bm);
  g.bpw = (rows_per_window + g.bm - 1) / g.bm;
  const dim3 grid((d_out + CO - 1) / CO);
  const size_t smem =
      sizeof(float) * (CI * CO + 2 * static_cast<size_t>(B) * CO + static_cast<size_t>(B) * CI) +
      CI * CO;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kind < qz::KIND_F32 || kind > qz::KIND_U16) return static_cast<int>(cudaErrorInvalidValue);
  if (d == 8) {
    launch<8>(kind, grid, smem, st, words, qbits, step, X, Y, B, s, g);
  } else {
    launch<0>(kind, grid, smem, st, words, qbits, step, X, Y, B, s, g);
  }
  return static_cast<int>(cudaGetLastError());
}

int qz_edges(const void* words, int kind, int qbits, unsigned step,
             const long long* rows, int R, unsigned seed, unsigned tensor_id,
             int window, unsigned rows_per_window, int d, float sigma,
             int* idx, unsigned char* bits, float* vals, float* w,
             void* stream) {
  const qz::SpecArgs s = spec_args(seed, tensor_id, window, rows_per_window, d, sigma);
  const int threads = 128;
  const dim3 grid((R + threads - 1) / threads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case qz::KIND_F32:
      edges_kernel<qz::KIND_F32><<<grid, threads, 0, st>>>(words, qbits, step, rows, R, s, idx, bits, vals, w);
      break;
    case qz::KIND_U8:
      edges_kernel<qz::KIND_U8><<<grid, threads, 0, st>>>(words, qbits, step, rows, R, s, idx, bits, vals, w);
      break;
    case qz::KIND_U16:
      edges_kernel<qz::KIND_U16><<<grid, threads, 0, st>>>(words, qbits, step, rows, R, s, idx, bits, vals, w);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
