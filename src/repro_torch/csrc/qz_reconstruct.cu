// The training kernels for Hopper: the reconstruct forward (from explicit
// masks or drawn in the body), the transpose-plan backward, the scatter
// backward and the upload sample-pack.  Device functions (hash, Q-row regeneration, mask
// draw, quantized threshold, Box-Muller) come from qz_common.cuh, the
// code the serve kernel (qz_decode.cu) already holds bitwise against
// torch.
//
// reconstruct_rows is the forward of four Pallas kernels of
// src/repro/kernels/qz_reconstruct.py.  W[k, r] = sum_j vals[r, j] *
// z_k[idx[r, j]] in ascending j, each multiply and add rounded on its
// own, with z_k either
//   - drawn in the body, z_k ~ Bern(p_k) from the hash stream at the
//     edge's coordinate (f32 probabilities, or the u8/u16 threshold
//     compare): sample_reconstruct_kernel, replacing
//     qz_sample_reconstruct_batched_fwd and, at K = 1,
//     qz_sample_reconstruct_fwd;
//   - read from an explicit (K, n) f32 operand (masks, or the
//     probabilities themselves in continuous mode):
//     mask_reconstruct_kernel, replacing qz_reconstruct_batched_fwd and,
//     at K = 1, qz_reconstruct_fwd.
// One thread owns one row.  It regenerates the row's edges (coordinates
// and values) once, into shared memory that only it reads, then for each
// of the K clients gathers that client's operand at each edge and sums.
// A row's d edges are staged CHUNK at a time, so any d fits (the paper
// runs d up to 256); a later chunk picks the client's partial sum back
// up from W, which holds exactly the float the thread wrote, so the sum
// is the same ascending-j sequence of rounded adds as with one chunk.
// The Pallas kernels gather through a one-hot MXU product; here it is a
// plain gather.  Only the valid rows [0, m) of the single-block layout
// are computed (the padding rows the JAX wrapper slices off are never
// formed).
// Bound: at MNISTFC width, bytes for the drawn forward at K = 10 and
// operations for K = 1.  The least work is per row 2 row hashes, per
// edge its index and, where some client's operand is not 0, 2 value
// hashes and a Box-Muller; per (client, edge) a multiply-add where the
// operand is not 0; for a drawn operand one mask hash and a compare per
// (client, coordinate) (this kernel redraws per (client, edge)).
// Against that, the K operand rows read and the K output rows written.
//
// plan_bwd_kernel replaces qz_reconstruct_batched_bwd_plan (K > 1; K = 1
// has plan_bwd_one_kernel, below).  It reads the global
// (num_windows, window, deg) transpose plan directly (no per-row-block
// re-binning as the Pallas grid needs): one thread per (coordinate,
// client) sums vals[c, e] * g_k[w*rpw + rows[c, e]] over e in ascending
// order from +0, each multiply and add rounded on its own, in the order
// of the plan it is given (canonical or slot).  Padding entries (value
// 0) add zeros, which change nothing after a +0 start.
// Bound: bytes (the plan's rows and values dominate).
//
// scatter_bwd_kernel replaces qz_reconstruct_batched_bwd (K > 1; K = 1 has
// scatter_bwd_one_kernel, below): grad_Z[k] = Q^T G[k] with Q regenerated in the
// body, no plan read and none held.  Window w's rows [w*rpw, (w+1)*rpw)
// write only into its coordinates [w*window, (w+1)*window), so one CTA
// owns one window and nothing crosses CTAs.  It takes the window's valid
// rows a chunk at a time, at most SC_EDGES edges, and per chunk
//   1. regenerates each row's edges (a row whose cotangent is 0 for
//      every client adds only zeros and is skipped), keeping each edge's
//      value in shared memory by its edge id e = row * d + k, and counts
//      the edges of each coordinate;
//   2. turns the counts into bin offsets (a block-wide exclusive scan);
//   3. places each edge id in its coordinate's bin, a round of rows at a
//      time, and sorts each bin by edge id, so a coordinate's edges run
//      in ascending (row, k), the canonical order (shared-memory atomics
//      only hand out places in a bin; the sort makes their order fixed);
//   4. sums, for every client, each coordinate's bin in that order, one
//      thread per coordinate, from +0 on the first chunk and from the
//      partial sum it wrote on a later one, each multiply and add
//      rounded on its own.
// So each coordinate's sum is the canonical plan's sequence of rounded
// adds without its padding entries, and equals plan_bwd_kernel's on the
// canonical plan bit for bit; no atomic touches a sum.  The Pallas
// kernel forms the same sum as a one-hot MXU product per row block; a
// product on the tensor cores would round to TF32, so this is a gather.
// Bound: operations where the cotangent is dense (regenerating an edge,
// its index, 2 value hashes and a Box-Muller, is ~60 operations; a row's
// d = 8 edges ~480 against its 4 K = 16 bytes of cotangent at K = 4),
// bytes where most rows carry none (an embedding's: G is read whole to
// find the live rows, which alone are regenerated).
//
// scatter_bwd_one_kernel replaces qz_reconstruct_bwd (K = 1; the local
// backward under REPRO_BWD_PLAN=scatter): grad_z = Q^T g, the same sums
// as scatter_bwd_kernel's row, sized for the windows it runs at (Fig. 6:
// 128 rows of d = 16, 2,048 edges, 128 coordinates).  A CTA of
// S1_THREADS owns a window and takes its valid rows a pass of chunk_rows
// rows (at most S1_EDGES of kernels/qz_reconstruct.py's edges) at a
// time; per pass
//   0. a thread per row: its hash state, base, stride and the stride's
//      inverse mod the window, and its cotangent, into shared memory;
//   1. a thread per edge (e = i * d + j, neighbouring threads on
//      neighbouring edges): the edge's coordinate; where the row's
//      cotangent is not 0 (a row whose cotangent is 0 adds only zeros),
//      the product value * g[row], rounded on its own, into shared
//      memory at e, and the row's bit in the coordinate's row mask (an
//      atomic OR: the mask does not depend on the order of the ORs);
//   2. a thread per coordinate walks the set bits of its row mask in
//      ascending row i; row i reaches coordinate c at one slot only,
//      j = (c - base) * stride^-1 mod window, so it adds the product at
//      i * d + j: ascending (row, j), the canonical order, by
//      construction.  It sums from +0 on the first pass and from the
//      partial sum it wrote on a later one (one pass holds a Fig. 6
//      window, so each sum is written once).
// No sort, no scan, 3 barriers a pass.  Shared memory is sized to the
// pass: 12.9 KB a CTA at Fig. 6, so many CTAs share an SM.  Bound:
// operations (the edge's index, two value hashes past their slot's
// mixed counter, and a Box-Muller).
//
// plan_bwd_one_kernel replaces qz_reconstruct_bwd_plan (K = 1: every
// local backward, and each rank's in the sharded round).  It reads the
// plan's compact layout (core.transpose_plan.build_plan_layout): only
// the m*d real entries, in the plan's order (canonical or slot), each
// coordinate's list [starts[c], starts[c+1]), the window-local row as
// uint16 where rows_per_window allows.  A window's entries are one
// contiguous slab.  One CTA owns one window: it stages the window's
// cotangents (where they fit) and a piece of the slab at a time with
// coalesced loads into shared memory, then a thread per coordinate walks
// its list from shared memory, from +0 (or the partial sum it wrote for
// the previous piece), each multiply and add rounded on its own.  Its
// sums are plan_bwd_kernel's without the padding entries.  A padding
// entry adds 0 * g[the window's row 0], which is +-0 and changes no sum
// begun at +0 while that cotangent is finite; where it is Inf or NaN the
// padded walk gives NaN at every padded coordinate of the window and
// this walk does not (as scatter_bwd_kernel does not).  Bound: bytes (6
// bytes a real entry, the offsets, the cotangent and the output).
//
// sample_pack_kernel replaces qz_sample_pack_batched_fwd and, launched
// at K = 1 with its draw word a scalar argument, qz_sample_pack_fwd (each
// rank's upload in the sharded round).  One thread per (coordinate,
// client): a warp draws 32 neighbouring coordinates (one coalesced
// 128-byte read of p) and __ballot_sync puts thread j's bit at position
// j, which is bit j of the warp's lane: comm.bitpack.pack_mask's layout.
// The bits do not depend on the window, so any window packs.  Lanes are
// written as int64 holding the uint32 value, the port's carrier for
// 32-bit words.  Bound: bytes (4 bytes of probability in per bit out).
//
// Draw words arrive as the port carries them: int64 holding the uint32
// value (qz_sample_pack_one's one word as a scalar).  Every launch
// function returns the launch's cudaError_t.

#include <cuda_runtime.h>

#include <cstdint>

#include "qz_common.cuh"

namespace {

constexpr int THREADS = 128;

// scatter_bwd_kernel: threads per CTA, and edges per chunk (an edge id
// fits 16 bits; 6 bytes an edge, 96 KB, so two CTAs fit an SM)
constexpr int SC_THREADS = 512;
constexpr int SC_EDGES = 16384;

// A row's edges staged in shared memory at once: 8 bytes per edge and
// thread, 32 KB a CTA, plus 4 bytes per client (at most 4 KB), under the
// 48 KB a launch gets without opting in to more.
constexpr int CHUNK = 32;

// The explicit f32 operand of mask_reconstruct_kernel: no draw.
constexpr int KIND_VALUES = 3;

template <int KIND>
__device__ __forceinline__ const void* client_words(const void* P, int k,
                                                    long long n) {
  const long long off = static_cast<long long>(k) * n;
  if (KIND == qz::KIND_F32 || KIND == KIND_VALUES) {
    return static_cast<const float*>(P) + off;
  }
  if (KIND == qz::KIND_U8) return static_cast<const uint8_t*>(P) + off;
  return static_cast<const uint16_t*>(P) + off;
}

// Client k's operand at a global coordinate: its value, or its drawn bit.
template <int KIND>
__device__ __forceinline__ float edge_operand(const void* __restrict__ words,
                                              uint32_t hm, uint32_t coord) {
  if (KIND == KIND_VALUES) return static_cast<const float*>(words)[coord];
  return qz::mask_bit<KIND>(words, hm, coord) ? 1.0f : 0.0f;
}

// Dynamic shared memory: K mask prefixes (drawn kinds), then ch x THREADS
// coordinates and ch x THREADS values, ch = min(d, CHUNK).  MULTI is
// d > CHUNK, fixed at compile time so that the one-chunk instance (every
// d the round and Fig. 6 run) has no chunk loop and no read-back.
template <int KIND, bool MULTI>
__device__ __forceinline__ void reconstruct_rows(const void* __restrict__ P,
                                            const long long* __restrict__ steps,
                                            int K, long long n, uint32_t m,
                                            const qz::SpecArgs& s,
                                            float* __restrict__ W) {
  extern __shared__ uint32_t smem[];
  const int ch = s.d < CHUNK ? s.d : CHUNK;
  const int nh = KIND == KIND_VALUES ? 0 : K;
  uint32_t* sHm = smem;
  uint32_t* sCoord = sHm + nh;
  float* sVal = reinterpret_cast<float*>(sCoord + ch * THREADS);

  const int t = threadIdx.x;
  for (int k = t; k < nh; k += THREADS) {
    sHm[k] = qz::mask_prefix(s.seed, s.tensor_id, static_cast<uint32_t>(steps[k]));
  }
  __syncthreads();  // the only data threads share: the mask prefixes
  const uint32_t r = blockIdx.x * THREADS + t;
  if (r >= m) return;
  const uint32_t hq = qz::prefix2(s.seed, s.tensor_id);
  const qz::RowEdges e = qz::row_edges(hq, r, s.window);
  const uint32_t wbase = (r / s.rows_per_window) * s.window;
  for (int j0 = 0; j0 < (MULTI ? s.d : ch); j0 += ch) {
    const int nj = s.d - j0 < ch ? s.d - j0 : ch;
    for (int jj = 0; jj < nj; ++jj) {
      sCoord[jj * THREADS + t] = wbase + e.index(j0 + jj, s.window);
      sVal[jj * THREADS + t] = e.value(j0 + jj, s.sigma);
    }
    for (int k = 0; k < K; ++k) {
      const void* words = client_words<KIND>(P, k, n);
      const uint32_t hm = nh ? sHm[k] : 0u;
      float* out = W + static_cast<long long>(k) * m + r;
      // -0 + x == x for every x, so a sum started at -0 is the sum started
      // at the first product; a later chunk resumes from the partial sum
      // written for the last
      float acc = (MULTI && j0 > 0) ? *out : -0.0f;
      for (int jj = 0; jj < nj; ++jj) {
        const float z = edge_operand<KIND>(words, hm, sCoord[jj * THREADS + t]);
        acc = __fadd_rn(acc, __fmul_rn(sVal[jj * THREADS + t], z));
      }
      *out = acc;
    }
  }
}

template <int KIND>
__global__ void __launch_bounds__(THREADS)
sample_reconstruct_kernel(const void* __restrict__ P,
                          const long long* __restrict__ steps, int K,
                          long long n, uint32_t m, qz::SpecArgs s,
                          float* __restrict__ W) {
  if (s.d > CHUNK) {
    reconstruct_rows<KIND, true>(P, steps, K, n, m, s, W);
  } else {
    reconstruct_rows<KIND, false>(P, steps, K, n, m, s, W);
  }
}

__global__ void __launch_bounds__(THREADS)
mask_reconstruct_kernel(const float* __restrict__ Z, int K, long long n,
                        uint32_t m, qz::SpecArgs s, float* __restrict__ W) {
  if (s.d > CHUNK) {
    reconstruct_rows<KIND_VALUES, true>(Z, nullptr, K, n, m, s, W);
  } else {
    reconstruct_rows<KIND_VALUES, false>(Z, nullptr, K, n, m, s, W);
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
    acc = __fadd_rn(acc, __fmul_rn(vals[base + e], gv));
  }
  out[static_cast<long long>(k) * n + c] = acc;
}

// Dynamic shared memory of scatter_bwd_kernel: per coordinate a bin start
// and a cursor, the warps' scan totals, per edge its value and its place
// in a bin.
size_t scatter_smem(int window) {
  return sizeof(uint32_t) * (2u * static_cast<size_t>(window) + SC_THREADS / 32)
         + (sizeof(float) + sizeof(uint16_t)) * static_cast<size_t>(SC_EDGES);
}

// Exclusive scan of cnt[0, window) into beg and cnt (cnt becomes each
// bin's cursor).  Each thread scans a contiguous run of bins.
__device__ __forceinline__ void bin_offsets(uint32_t* cnt, uint32_t* beg,
                                            uint32_t* warp_tot, int window) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int per = (window + SC_THREADS - 1) / SC_THREADS;
  const int lo = min(t * per, window), hi = min(lo + per, window);
  uint32_t own = 0;
  for (int c = lo; c < hi; ++c) own += cnt[c];
  uint32_t x = own;  // inclusive scan within the warp
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_tot[warp] = x;
  __syncthreads();
  if (warp == 0) {
    uint32_t v = lane < SC_THREADS / 32 ? warp_tot[lane] : 0u;
    for (int o = 1; o < 32; o <<= 1) {
      const uint32_t y = __shfl_up_sync(0xffffffffu, v, o);
      if (lane >= o) v += y;
    }
    if (lane < SC_THREADS / 32) warp_tot[lane] = v;
  }
  __syncthreads();
  uint32_t at = (warp ? warp_tot[warp - 1] : 0u) + x - own;
  for (int c = lo; c < hi; ++c) {
    const uint32_t v = cnt[c];
    beg[c] = at;
    cnt[c] = at;
    at += v;
  }
}

__global__ void __launch_bounds__(SC_THREADS, 2)
scatter_bwd_kernel(const float* __restrict__ G, int K, uint32_t m, uint32_t n,
                   qz::SpecArgs s, float* __restrict__ out) {
  extern __shared__ uint32_t smem[];
  const int window = static_cast<int>(s.window);
  uint32_t* beg = smem;
  uint32_t* cur = beg + window;
  uint32_t* warp_tot = cur + window;
  float* sVal = reinterpret_cast<float*>(warp_tot + SC_THREADS / 32);
  uint16_t* sId = reinterpret_cast<uint16_t*>(sVal + SC_EDGES);

  const int t = threadIdx.x;
  const uint32_t w = blockIdx.x;
  const uint32_t c0 = w * s.window;
  const uint32_t r_lo = w * s.rows_per_window;
  const uint32_t r_hi = min(r_lo + s.rows_per_window, m);  // valid rows only
  const uint32_t hq = qz::prefix2(s.seed, s.tensor_id);
  const int d = s.d;
  const uint32_t chunk = static_cast<uint32_t>(SC_EDGES / d);
  for (int c = t; c < window; c += SC_THREADS) {  // a window with no row
    for (int k = 0; k < K; ++k) out[static_cast<long long>(k) * n + c0 + c] = 0.0f;
  }
  for (uint32_t r0 = r_lo; r0 < r_hi; r0 += chunk) {
    const uint32_t nrows = min(chunk, r_hi - r0);
    for (int c = t; c < window; c += SC_THREADS) cur[c] = 0u;
    __syncthreads();
    // 1. the chunk's edges: values by edge id, counts by coordinate
    for (uint32_t i = t; i < nrows; i += SC_THREADS) {
      bool live = false;
      for (int k = 0; k < K && !live; ++k) {
        live = G[static_cast<long long>(k) * m + r0 + i] != 0.0f;
      }
      if (!live) continue;
      const qz::RowEdges e = qz::row_edges(hq, r0 + i, s.window);
      for (int j = 0; j < d; ++j) {
        sVal[i * d + j] = e.value(j, s.sigma);
        atomicAdd(&cur[e.index(j, s.window)], 1u);
      }
    }
    __syncthreads();
    // 2. bin offsets
    bin_offsets(cur, beg, warp_tot, window);
    __syncthreads();
    // 3. edge ids into their bins, a round of SC_THREADS rows at a time,
    // so a bin holds the rounds in ascending order before it is sorted
    for (uint32_t i0 = 0; i0 < nrows; i0 += SC_THREADS) {
      const uint32_t i = i0 + t;
      bool live = false;
      for (int k = 0; k < K && i < nrows && !live; ++k) {
        live = G[static_cast<long long>(k) * m + r0 + i] != 0.0f;
      }
      if (live) {
        const qz::RowEdges e = qz::row_edges(hq, r0 + i, s.window);
        for (int j = 0; j < d; ++j) {
          const uint32_t at = atomicAdd(&cur[e.index(j, s.window)], 1u);
          sId[at] = static_cast<uint16_t>(i * d + j);
        }
      }
      __syncthreads();
    }
    // 3b. each bin sorted by edge id: ascending (row, k)
    for (int c = t; c < window; c += SC_THREADS) {
      const uint32_t b0 = beg[c], b1 = cur[c];
      for (uint32_t a = b0 + 1; a < b1; ++a) {
        const uint16_t v = sId[a];
        uint32_t b = a;
        for (; b > b0 && sId[b - 1] > v; --b) sId[b] = sId[b - 1];
        sId[b] = v;
      }
    }
    __syncthreads();
    // 4. every client's sum at each coordinate, in bin order
    for (int c = t; c < window; c += SC_THREADS) {
      const uint32_t b0 = beg[c], b1 = cur[c];
      for (int k = 0; k < K; ++k) {
        const float* g = G + static_cast<long long>(k) * m + r0;
        float* o = out + static_cast<long long>(k) * n + c0 + c;
        float acc = *o;  // +0 before the first chunk, else its partial sum
        for (uint32_t a = b0; a < b1; ++a) {
          const uint32_t id = sId[a];
          acc = __fadd_rn(acc, __fmul_rn(sVal[id], g[id / static_cast<uint32_t>(d)]));
        }
        *o = acc;
      }
    }
    __syncthreads();  // the next chunk reuses the shared memory
  }
}

// scatter_bwd_one_kernel: threads (the launch geometry,
// scatter_one_plan in kernels/qz_reconstruct.py, reads them from here)
constexpr int S1_THREADS = 256;

struct ScatterOneArgs {
  qz::SpecArgs s;
  uint32_t m;
  uint32_t chunk_rows;    // rows a pass
  uint32_t mask_stride;   // words a coordinate's row mask takes, odd
  qz::Div div_d;          // / d
};

// Dynamic shared memory (uint32 words): the coordinates' row masks, per slot
// j the mixed value counters, per row its hash state, base | stride <<
// 16, the stride's inverse and the cotangent, per edge of a pass its
// product.
__host__ __device__ __forceinline__ size_t scatter_one_words(uint32_t window,
                                                             uint32_t mask_stride,
                                                             uint32_t chunk_rows,
                                                             int d) {
  return static_cast<size_t>(window) * mask_stride + 2u * static_cast<size_t>(d)
         + 4u * static_cast<size_t>(chunk_rows)
         + static_cast<size_t>(chunk_rows) * d;
}

// RowEdges::value with the edge's two counters already mixed:
// hash_row_ctr(hr, ctr) = fmix32((hr ^ fmix32(ctr + K1)) * K2 + K1), and
// fmix32(ctr + K1) depends on the slot j only.
__device__ __forceinline__ float mixed_value(uint32_t hr, uint32_t ma,
                                             uint32_t mb, float sigma) {
  const uint32_t ua = qz::fmix32((hr ^ ma) * qz::K2 + qz::K1);
  const uint32_t ub = qz::fmix32((hr ^ mb) * qz::K2 + qz::K1);
  return __fmul_rn(qz::gaussian_from_u32(ua, ub), sigma);
}

__global__ void __launch_bounds__(S1_THREADS)
scatter_bwd_one_kernel(const float* __restrict__ g, ScatterOneArgs a,
                       float* __restrict__ out) {
  extern __shared__ uint32_t smem[];
  const uint32_t window = a.s.window, wmask = window - 1u;
  const uint32_t d = static_cast<uint32_t>(a.s.d);
  uint32_t* mask = smem;
  uint32_t* sMa = mask + window * a.mask_stride;
  uint32_t* sMb = sMa + d;
  uint32_t* sHr = sMb + d;
  uint32_t* sBS = sHr + a.chunk_rows;
  uint32_t* sInv = sBS + a.chunk_rows;
  float* sG = reinterpret_cast<float*>(sInv + a.chunk_rows);
  float* sProd = sG + a.chunk_rows;

  const uint32_t t = threadIdx.x;
  const uint32_t r_lo = blockIdx.x * a.s.rows_per_window;
  const uint32_t r_hi = r_lo < a.m ? min(r_lo + a.s.rows_per_window, a.m) : r_lo;
  const uint32_t hq = qz::prefix2(a.s.seed, a.s.tensor_id);
  for (uint32_t j = t; j < d; j += S1_THREADS) {
    sMa[j] = qz::fmix32(qz::CTR_VAL + 2u * j + qz::K1);
    sMb[j] = qz::fmix32(qz::CTR_VAL + 2u * j + 1u + qz::K1);
  }
  for (uint32_t r0 = r_lo;; r0 += a.chunk_rows) {  // a window with no row: one empty pass
    const uint32_t nrows = r0 < r_hi ? min(a.chunk_rows, r_hi - r0) : 0u;
    const uint32_t words = (nrows + 31u) / 32u;  // of each row mask this pass
    // 0. the pass's rows; the masks to 0
    for (uint32_t i = t; i < window * a.mask_stride; i += S1_THREADS) mask[i] = 0u;
    for (uint32_t i = t; i < nrows; i += S1_THREADS) {
      const qz::RowEdges e = qz::row_edges(hq, r0 + i, a.s.window);
      uint32_t inv = e.stride;  // Newton: 3 -> 6 -> 12 -> 24 correct bits
      for (int k = 0; k < 3; ++k) inv *= 2u - e.stride * inv;
      sHr[i] = e.hr;
      sBS[i] = e.base | (e.stride << 16);
      sInv[i] = inv;
      sG[i] = g[r0 + i];
    }
    __syncthreads();
    // 1. the live edges: product at e, row bit in the coordinate's mask
    for (uint32_t e = t; e < nrows * d; e += S1_THREADS) {
      const uint32_t i = a.div_d(e), j = e - i * d;
      const float gv = sG[i];
      const uint32_t bs = sBS[i];
      const uint32_t c = ((bs & 0xFFFFu) + (bs >> 16) * j) & wmask;
      if (gv != 0.0f) {
        sProd[e] = __fmul_rn(mixed_value(sHr[i], sMa[j], sMb[j], a.s.sigma), gv);
        atomicOr(&mask[c * a.mask_stride + (i >> 5)], 1u << (i & 31u));
      }
    }
    __syncthreads();
    // 2. each coordinate's sum over its rows in ascending order
    for (uint32_t c = t; c < window; c += S1_THREADS) {
      float* o = out + blockIdx.x * window + c;
      float acc = r0 == r_lo ? 0.0f : *o;
      for (uint32_t k = 0; k < words; ++k) {
        for (uint32_t bits = mask[c * a.mask_stride + k]; bits; bits &= bits - 1u) {
          const uint32_t i = 32u * k + (__ffs(bits) - 1);
          const uint32_t j = ((c - (sBS[i] & 0xFFFFu)) * sInv[i]) & wmask;
          acc = __fadd_rn(acc, sProd[i * d + j]);
        }
      }
      *o = acc;
    }
    if (r0 + a.chunk_rows >= r_hi) break;
    __syncthreads();  // the next pass reuses the shared memory
  }
}

// plan_bwd_one_kernel: threads per CTA (read by plan_one_plan)
constexpr int P1_THREADS = 256;

struct PlanOneArgs {
  const void* rows;   // (E,) window-local rows, uint16 or uint32
  const float* vals;  // (E,)
  const int* starts;  // (n + 1,) coordinate c's entries [starts[c], starts[c+1])
  uint32_t m;
  uint32_t window;
  uint32_t rows_per_window;
  int piece;  // slab entries staged at once
};

// Dynamic shared memory: a piece's values and rows, then (STAGE_G) the
// window's cotangents.
__host__ __device__ __forceinline__ size_t plan_one_bytes(int piece, bool narrow,
                                                          bool stage_g,
                                                          uint32_t rows_per_window) {
  return static_cast<size_t>(piece) * (sizeof(float) + (narrow ? 2u : 4u))
         + (stage_g ? sizeof(float) * rows_per_window : 0u);
}

template <typename Row, bool STAGE_G>
__global__ void __launch_bounds__(P1_THREADS)
plan_bwd_one_kernel(const float* __restrict__ g, PlanOneArgs a,
                    float* __restrict__ out) {
  extern __shared__ uint32_t smem[];
  float* sVal = reinterpret_cast<float*>(smem);
  float* sG = sVal + a.piece;
  Row* sRow = reinterpret_cast<Row*>(sG + (STAGE_G ? a.rows_per_window : 0u));
  const Row* __restrict__ rows = static_cast<const Row*>(a.rows);
  const int t = threadIdx.x;
  const uint32_t c0 = blockIdx.x * a.window;
  const int s0 = a.starts[c0], s1 = a.starts[c0 + a.window];
  const uint32_t r0 = blockIdx.x * a.rows_per_window;
  const float* __restrict__ gw = g + r0;
  if (STAGE_G) {
    const uint32_t nr = r0 < a.m ? min(a.rows_per_window, a.m - r0) : 0u;
    for (uint32_t i = t; i < nr; i += P1_THREADS) sG[i] = gw[i];
  }
  for (int p0 = s0;; p0 += a.piece) {  // a window with no entry: one empty piece
    const int np = min(a.piece, s1 - p0);
    for (int i = t; i < np; i += P1_THREADS) {
      sVal[i] = a.vals[p0 + i];
      sRow[i] = rows[p0 + i];
    }
    __syncthreads();
    for (uint32_t c = t; c < a.window; c += P1_THREADS) {
      const int e1 = min(a.starts[c0 + c + 1], p0 + np);
      float acc = p0 == s0 ? 0.0f : out[c0 + c];
      for (int e = max(a.starts[c0 + c], p0); e < e1; ++e) {
        const uint32_t row = sRow[e - p0];
        const float gv = STAGE_G ? sG[row] : gw[row];
        acc = __fadd_rn(acc, __fmul_rn(sVal[e - p0], gv));
      }
      out[c0 + c] = acc;
    }
    if (p0 + a.piece >= s1) break;
    __syncthreads();  // the next piece reuses the shared memory
  }
}

__global__ void __launch_bounds__(THREADS)
sample_pack_kernel(const float* __restrict__ P,
                   const long long* __restrict__ steps, uint32_t word,
                   uint32_t n, uint32_t lanes, uint32_t seed,
                   uint32_t tensor_id, long long* __restrict__ out) {
  const uint32_t coord = blockIdx.x * THREADS + threadIdx.x;
  const int k = blockIdx.y;
  // steps null: one client, drawn at the scalar word
  const uint32_t step = steps ? static_cast<uint32_t>(steps[k]) : word;
  const uint32_t hm = qz::mask_prefix(seed, tensor_id, step);
  // every thread of the warp reaches the ballot; past n a bit is 0
  const bool bit = coord < n && qz::mask_bit<qz::KIND_F32>(
                                    P + static_cast<long long>(k) * n, hm, coord);
  const uint32_t lane = __ballot_sync(0xFFFFFFFFu, bit);
  if ((threadIdx.x & 31u) == 0u && coord / 32u < lanes) {
    out[static_cast<long long>(k) * lanes + coord / 32u] = static_cast<long long>(lane);
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

// Dynamic shared memory of reconstruct_rows for nh mask prefixes and degree d.
size_t rows_smem(int nh, int d) {
  const int ch = d < CHUNK ? d : CHUNK;
  return sizeof(uint32_t) * (static_cast<size_t>(nh) + 2u * ch * THREADS);
}

// Above 48 KB of dynamic shared memory a kernel must opt in, once per
// size it grows to.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int smem, int& opted) {
  if (smem <= 48 * 1024 || smem <= opted) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess) opted = smem;
  return err;
}

}  // namespace

// A leaf's launch constants for kernel 2, made once by the wrapper
// (kernels/qz_reconstruct.py, scatter_one_plan) and passed by pointer.
struct ScatterOneConsts {
  unsigned seed, tensor_id;
  int window;
  unsigned rows_per_window;
  int d;
  float sigma;
  unsigned m, num_windows, chunk_rows, mask_stride, div_m, div_s1, div_s2;
  int smem;
};

// A leaf's launch constants for kernel 5: its compact plan layout on the
// card and the geometry (plan_one_plan).
struct PlanOneConsts {
  const void* rows;
  const float* vals;
  const int* starts;
  unsigned m, window, rows_per_window, num_windows;
  int piece, narrow, stage_g, smem;
};

extern "C" {

// W (K, m) = Q Bern(P_k) for the K clients' operands P (K, n).
int qz_sample_reconstruct(const void* P, int kind,
                          const long long* steps, int K, long long n,
                          unsigned m, unsigned seed, unsigned tensor_id,
                          int window, unsigned rows_per_window, int d,
                          float sigma, float* W, void* stream) {
  const qz::SpecArgs s = spec_args(seed, tensor_id, window, rows_per_window, d, sigma);
  const dim3 grid((m + THREADS - 1) / THREADS);
  const size_t smem = rows_smem(K, d);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case qz::KIND_F32:
      sample_reconstruct_kernel<qz::KIND_F32><<<grid, THREADS, smem, st>>>(P, steps, K, n, m, s, W);
      break;
    case qz::KIND_U8:
      sample_reconstruct_kernel<qz::KIND_U8><<<grid, THREADS, smem, st>>>(P, steps, K, n, m, s, W);
      break;
    case qz::KIND_U16:
      sample_reconstruct_kernel<qz::KIND_U16><<<grid, THREADS, smem, st>>>(P, steps, K, n, m, s, W);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// W (K, m) = Q Z_k for the K clients' explicit operands Z (K, n).
int qz_reconstruct_batched(const float* Z, int K, long long n, unsigned m,
                           unsigned seed, unsigned tensor_id, int window,
                           unsigned rows_per_window, int d, float sigma,
                           float* W, void* stream) {
  const qz::SpecArgs s = spec_args(seed, tensor_id, window, rows_per_window, d, sigma);
  const dim3 grid((m + THREADS - 1) / THREADS);
  mask_reconstruct_kernel<<<grid, THREADS, rows_smem(0, d), static_cast<cudaStream_t>(stream)>>>(
      Z, K, n, m, s, W);
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

// out (K, n) = Q^T G_k by the scatter, Q regenerated; G (K, m) moved order.
int qz_scatter_bwd(const float* G, int K, unsigned n, unsigned m,
                   unsigned seed, unsigned tensor_id, int window,
                   unsigned rows_per_window, int num_windows, int d,
                   float sigma, float* out, void* stream) {
  if (d < 1 || d > SC_EDGES) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = scatter_smem(window);
  static size_t opted_in = 0;  // above 48 KB a kernel must opt in
  if (smem > opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        scatter_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in = smem;
  }
  const qz::SpecArgs s = spec_args(seed, tensor_id, window, rows_per_window, d, sigma);
  scatter_bwd_kernel<<<num_windows, SC_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      G, K, m, n, s, out);
  return static_cast<int>(cudaGetLastError());
}

// grad_z (n,) = Q^T g by the scatter for one cotangent g (m,).
int qz_scatter_bwd_one(const float* g, float* out, const ScatterOneConsts* c,
                       void* stream) {
  // the geometry is scatter_one_plan's; checked here is what the body
  // needs: a power-of-two window whose base | stride << 16 packs into 32
  // bits, a row mask of a pass's rows, shared memory of its layout
  const int w = c->window;
  if (w < 2 || w > 65536 || (w & (w - 1)) || c->d < 1 || c->chunk_rows < 1 ||
      32 * c->mask_stride < c->chunk_rows ||
      static_cast<size_t>(c->smem) !=
          4 * scatter_one_words(w, c->mask_stride, c->chunk_rows, c->d)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  static int opted = 0;
  const cudaError_t err = allow_smem(scatter_bwd_one_kernel, c->smem, opted);
  if (err != cudaSuccess) return static_cast<int>(err);
  ScatterOneArgs a;
  a.s = spec_args(c->seed, c->tensor_id, w, c->rows_per_window, c->d, c->sigma);
  a.m = c->m;
  a.chunk_rows = c->chunk_rows;
  a.mask_stride = c->mask_stride;
  a.div_d = {c->div_m, c->div_s1, c->div_s2};
  scatter_bwd_one_kernel<<<c->num_windows, S1_THREADS, c->smem,
                           static_cast<cudaStream_t>(stream)>>>(g, a, out);
  return static_cast<int>(cudaGetLastError());
}

// grad_z (n,) = Q^T g over the compact plan layout for one cotangent g (m,).
int qz_plan_bwd_one(const float* g, float* out, const PlanOneConsts* c,
                    void* stream) {
  if (c->piece < 1 || c->window < 1 ||
      static_cast<size_t>(c->smem) !=
          plan_one_bytes(c->piece, c->narrow, c->stage_g, c->rows_per_window)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  PlanOneArgs a;
  a.rows = c->rows;
  a.vals = c->vals;
  a.starts = c->starts;
  a.m = c->m;
  a.window = c->window;
  a.rows_per_window = c->rows_per_window;
  a.piece = c->piece;
  static int opted[4] = {0, 0, 0, 0};
  const int which = (c->narrow ? 2 : 0) + (c->stage_g ? 1 : 0);
  auto kernel = c->narrow ? (c->stage_g ? plan_bwd_one_kernel<uint16_t, true>
                                        : plan_bwd_one_kernel<uint16_t, false>)
                          : (c->stage_g ? plan_bwd_one_kernel<uint32_t, true>
                                        : plan_bwd_one_kernel<uint32_t, false>);
  const cudaError_t err = allow_smem(kernel, c->smem, opted[which]);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<c->num_windows, P1_THREADS, c->smem, static_cast<cudaStream_t>(stream)>>>(
      g, a, out);
  return static_cast<int>(cudaGetLastError());
}

static int launch_sample_pack(const float* P, const long long* steps,
                              unsigned word, int K, long long n,
                              unsigned seed, unsigned tensor_id,
                              long long* out, void* stream) {
  if (n <= 0 || n > 0xFFFFFFE0LL || K < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const uint32_t lanes = static_cast<uint32_t>((n + 31) / 32);
  const dim3 grid((lanes * 32u + THREADS - 1) / THREADS, K);
  sample_pack_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      P, steps, word, static_cast<uint32_t>(n), lanes, seed, tensor_id, out);
  return static_cast<int>(cudaGetLastError());
}

// out (K, ceil(n/32)) lanes of Bern(P_k), P (K, n) f32 probabilities.
int qz_sample_pack(const float* P, const long long* steps, int K, long long n,
                   unsigned seed, unsigned tensor_id, long long* out,
                   void* stream) {
  return launch_sample_pack(P, steps, 0u, K, n, seed, tensor_id, out, stream);
}

// out (ceil(n/32),) lanes of Bern(p), p (n,) f32 probabilities drawn at
// the one draw word ``word``: sample_pack_kernel at K = 1.
int qz_sample_pack_one(const float* p, unsigned word, unsigned n,
                       unsigned seed, unsigned tensor_id, long long* out,
                       void* stream) {
  return launch_sample_pack(p, nullptr, word, 1, n, seed, tensor_id, out,
                            stream);
}

}  // extern "C"
