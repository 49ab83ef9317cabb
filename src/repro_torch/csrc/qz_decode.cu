// Streamed serve matmul for Hopper: Y = X @ W_g, with W_g regenerated
// from the encoded score words and never written to device memory.
//
// Replaces the Pallas kernels qz_sample_matmul / qz_sample_matvec
// (src/repro/kernels/qz_decode.py).  Per weight it regenerates the row's
// d Q edges from the counter hash, draws each edge's mask bit from the
// score word at the edge's z coordinate (f32 Bernoulli compare, or the
// u8/u16 widened-threshold integer compare) and sums vals * bits.
//
// Bound: the instructions the card issues, not the bytes (a few a
// weight) and not the float rate the stated bound counts them at.  A
// weight costs 2 row hashes, then per edge a mask bit and, per drawn edge
// (about half at uniform scores), 2 value hashes and a Box-Muller (logf,
// sqrtf, cosf).  Drawn edge by edge that is some 1300 instructions of a
// lane, and the first design also held the regeneration back on the
// ordered walk.  This one issues about 600 and keeps the card busy
// whatever the shape:
//
// - Each coordinate's mask bit is drawn once a call.  A window's 512
//   coordinates serve its 4096 rows' 32768 edges, so phase 1 draws the
//   group's bits (a warp ballot packs 32) into a scratch of n / 8 bytes,
//   and after a grid-wide barrier an edge reads its bit instead of
//   hashing its coordinate.  The launch is cooperative: one CTA per slot
//   the card holds, all resident, so the barrier cannot wait on a CTA
//   that has not started.
// - Phase 2: the CTAs take tiles of co output columns (a power of two
//   that serve_plan picks) from a counter.  A tile is all d_in rows of
//   its columns, regenerated into shared memory, then walked; while one
//   CTA walks, the others on its SM regenerate.  So a narrow d_out no
//   longer leaves SMs idle: the grid is the card's, not d_out / 8.
// - At d = 8 (fixed at compile time) a lane takes 2 weights a pass and
//   draws their 16 bits; the warp lists its drawn edges (a prefix sum of
//   the lanes' counts) and deals them out across its 32 lanes for the
//   value hashes and Box-Muller, so an undrawn edge, whose product is an
//   exact zero, costs neither and no lane waits on another's.  The
//   owning lane then sums its weights' values in ascending k.  Other
//   degrees take one weight per thread, as qz::edge_weight does.
// - logf, sqrtf and cosf are the library's own steps without the branches
//   for arguments a draw never gives (qz_common.cuh; qz_gauss_check holds
//   them against the library at every argument).  No division by a
//   run-time value: window / 2 is a mask, rows per window and bm are
//   exact multiply-and-shift divisions whose magic numbers serve_plan
//   makes, and the threshold's 2^bits - 1 is a compile-time constant.
//
// A ring of row chunks with a dedicated walking warp (named barriers)
// was tried on the card and kept out: its 7 producing warps and per-chunk
// hand-offs cost more at lm_head and gate than the walk it hid at down
// and wq (PERF.md).  What is left is the walk of long, narrow tiles
// (down: 4864 rows a column) and the tail of each launch.
//
// Summation order (the canonical tree of src/repro_torch/kernels/ops.py):
// for output column o, input rows i ascend; the products x_i * W_io add
// into a partial sum that flushes into y_o whenever the next row of
// column o lies in another (window, bm) block, and at the last row.
// Every multiply and add is rounded on its own.  Once a tile is in
// shared memory, one thread owns one (batch row, column) pair and walks
// its rows in order, with x staged a chunk of rows at a time, so the
// result is the same for any batch size and equals the plain torch path
// bit for bit.
//
// Where d_out >= bm every row flushes: a block holds at most bm
// consecutive rows, and rows i and i+1 of a column are d_out apart.
// Then y adds each product straight in: the tree's part = +0 + prod
// differs from prod only for prod = -0, and y, which starts at +0, is
// never -0 (a rounded sum is -0 only if both terms are), so y + (+0) and
// y + (-0) are both y.  The same argument lets a walk step add rows of
// x = 0 and w = 0 past d_in, so its unrolled loop needs no tail.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "qz_common.cuh"

namespace cg = cooperative_groups;

// The per-call constants of a group at a batch size (serve_plan's
// geometry included), made once by the wrapper and passed by pointer (at
// namespace scope: the C entries take it).
struct ServeConsts {
  int kind;
  unsigned seed, tensor_id;
  int window;
  unsigned rows_per_window;
  int d;
  float sigma;
  int d_in, d_out;
  unsigned bpw, rpw_m, rpw_s1, rpw_s2, bm_m, bm_s1, bm_s2;
  int co, rows, chunk, smem, all_flush;
};

namespace {

constexpr int THREADS = 256;
constexpr int D8 = 8;                        // the served degree
constexpr int SLOTS = 2;                     // weights a lane draws at once
constexpr int LANE_EDGES = SLOTS * D8;       // bits of a lane's drawn mask
constexpr int WARP_EDGES = 32 * LANE_EDGES;  // list entries of a warp pass
constexpr int PASS = THREADS * SLOTS;        // weights of a CTA pass

struct GroupArgs {
  uint32_t row_offset;  // first flat row of the group
  int d_in;
  int d_out;
  uint32_t bpw;       // canonical blocks per window
  qz::Div rpw;        // / rows_per_window
  qz::Div bm;         // / rows per canonical block
  uint32_t w0;        // first window of the group's rows
  uint32_t n_coords;  // coordinates of the group's windows
};

// Launch geometry, as serve_plan returns it.
struct Plan {
  int co;        // output columns of a tile, a power of two
  int co_shift;  // log2(co)
  int tiles;     // ceil(d_out / co)
  int rows;      // d_in rounded up to 8: rows of a tile in shared memory
  int chunk;     // input rows of x a walk step stages, a multiple of 8
};

__device__ __forceinline__ uint32_t block_of(uint32_t r, uint32_t rpw,
                                             const GroupArgs& g) {
  const uint32_t win = g.rpw(r);
  return win * g.bpw + g.bm(r - win * rpw);
}

// Phase 1: bit c of bits is the mask bit of coordinate w0 * window + c.
template <int KIND>
__device__ __forceinline__ void draw_bits(const void* __restrict__ words,
                                          const qz::SpecArgs& s,
                                          const GroupArgs& g, uint32_t hm,
                                          uint32_t* bits) {
  const uint32_t lane = threadIdx.x & 31u;
  const uint32_t nwords = (g.n_coords + 31u) / 32u;
  const uint32_t c0 = g.w0 * s.window;
  const uint32_t warps = gridDim.x * (THREADS / 32);
  for (uint32_t wi = (blockIdx.x * THREADS + threadIdx.x) / 32u; wi < nwords;
       wi += warps) {
    const uint32_t c = wi * 32u + lane;
    const bool b = c < g.n_coords && qz::mask_bit<KIND>(words, hm, c0 + c);
    const uint32_t word = __ballot_sync(0xFFFFFFFFu, b);
    if (lane == 0) bits[wi] = word;
  }
}

// A tile's weights at d = 8: sW[e] for entry e = row * co + column, rows
// past d_in 0.  Scratch (aux, 32-bit words; serve_plan's REGEN_BYTES):
// per warp its list of drawn edges (overwritten by their values) and its
// lanes' row hashes.  vk[j] = fmix32(CTR_VAL + j + K1), j < 2 d.
template <int KIND>
__device__ __forceinline__ void regenerate_d8(
    const qz::SpecArgs& s, const GroupArgs& g, const Plan& p,
    const uint32_t* bits, const uint32_t* vk, uint32_t hq, int o0,
    float* __restrict__ sW, uint32_t* __restrict__ aux) {
  const int t = threadIdx.x, lane = t & 31;
  uint32_t* items = aux + (t >> 5) * (WARP_EDGES + 32 * SLOTS);
  uint32_t* hrs = items + WARP_EDGES;
  float* vals = reinterpret_cast<float*>(items);
  const int tile_w = p.rows * p.co;
  const uint32_t wmask = s.window - 1u, smask = s.window / 2u - 1u;
  for (int e0 = 0; e0 < tile_w; e0 += PASS) {
    // each lane's 2 weights: row hash, and the 16 edges' mask bits
    uint32_t drawn = 0;
#pragma unroll
    for (int j = 0; j < SLOTS; ++j) {
      const int e = e0 + j * THREADS + t;
      const int i = e >> p.co_shift, o = o0 + (e & (p.co - 1));
      uint32_t hr = 0;
      if (e < tile_w && i < g.d_in && o < g.d_out) {
        const uint32_t r = g.row_offset + static_cast<uint32_t>(i) * g.d_out + o;
        hr = qz::combine(hq, r);
        // (base + stride k) & wmask, with base unmasked: the same index
        uint32_t at = qz::hash_row_ctr(hr, qz::CTR_BASE);
        const uint32_t stride = (qz::hash_row_ctr(hr, qz::CTR_STRIDE) & smask) * 2u + 1u;
        const uint32_t wrel = (g.rpw(r) - g.w0) * s.window;
#pragma unroll
        for (int k = 0; k < D8; ++k) {
          const uint32_t c = wrel + (at & wmask);
          drawn |= ((bits[c / 32u] >> (c % 32u)) & 1u) << (j * D8 + k);
          at += stride;
        }
      }
      hrs[lane * SLOTS + j] = hr;
    }
    // the warp's drawn edges, listed lane by lane in ascending bit order
    const int cnt = __popc(drawn);
    int incl = cnt;
#pragma unroll
    for (int dd = 1; dd < 32; dd <<= 1) {
      const int v = __shfl_up_sync(0xFFFFFFFFu, incl, dd);
      if (lane >= dd) incl += v;
    }
    const int total = __shfl_sync(0xFFFFFFFFu, incl, 31);
    const int first = incl - cnt;
    int pos = first;
    for (uint32_t m = drawn; m; m &= m - 1u) {
      items[pos++] = static_cast<uint32_t>(lane * LANE_EDGES + __ffs(m) - 1);
    }
    __syncwarp();
    // every lane takes every 32nd entry: its value replaces it
    for (int it = lane; it < total; it += 32) {
      const uint32_t item = items[it];
      const uint32_t hr = hrs[item / D8];
      const uint32_t k2 = 2u * (item % D8);
      const uint32_t ua = qz::fmix32((hr ^ vk[k2]) * qz::K2 + qz::K1);
      const uint32_t ub = qz::fmix32((hr ^ vk[k2 + 1u]) * qz::K2 + qz::K1);
      vals[it] = __fmul_rn(qz::gaussian_from_u32(ua, ub), s.sigma);
    }
    __syncwarp();
    // each weight: sum over k ascending of its drawn values, 0 elsewhere
    pos = first;
#pragma unroll
    for (int j = 0; j < SLOTS; ++j) {
      float acc = 0.0f;
#pragma unroll
      for (int k = 0; k < D8; ++k) {
        float prod = 0.0f;
        if ((drawn >> (j * D8 + k)) & 1u) prod = vals[pos++];
        acc = (k == 0) ? prod : __fadd_rn(acc, prod);
      }
      const int e = e0 + j * THREADS + t;
      if (e < tile_w) sW[(e & (p.co - 1)) * (p.rows + 4) + (e >> p.co_shift)] = acc;
    }
    __syncwarp();  // the next pass rewrites the list
  }
}

// A tile's weights at any degree: one weight per thread, qz::edge_weight.
template <int KIND>
__device__ __forceinline__ void regenerate_any(
    const void* __restrict__ words, const qz::SpecArgs& s, const GroupArgs& g,
    const Plan& p, uint32_t hq, uint32_t hm, int o0, float* __restrict__ sW) {
  const int tile_w = p.rows * p.co;
  for (int e = threadIdx.x; e < tile_w; e += THREADS) {
    const int i = e >> p.co_shift, o = o0 + (e & (p.co - 1));
    float w = 0.0f;
    if (i < g.d_in && o < g.d_out) {
      w = qz::edge_weight<KIND>(s, hq, hm, words,
                                g.row_offset + static_cast<uint32_t>(i) * g.d_out + o);
    }
    sW[(e & (p.co - 1)) * (p.rows + 4) + (e >> p.co_shift)] = w;
  }
}

// The ordered walk of a tile: every (batch row, column) over all d_in
// rows, x (and, below bm, each row's flush flag) staged a chunk at a
// time by the whole CTA; writes the tile's columns of Y.
template <bool ALL_FLUSH>
__device__ __forceinline__ void walk(const float* __restrict__ X,
                                     float* __restrict__ Y, int B,
                                     uint32_t rpw, const GroupArgs& g,
                                     const Plan& p, int o0,
                                     const float* __restrict__ sW,
                                     float* __restrict__ aux) {
  const int t = threadIdx.x;
  const int R = p.chunk, co = p.co;
  float* xs = aux;                 // B x R activations of the step
  float* acc_s = xs + B * R;       // B x co sums
  float* part_s = acc_s + B * co;  // B x co open partial sums
  // co x R flags: the column's sum flushes after the row
  unsigned char* flush = reinterpret_cast<unsigned char*>(part_s + B * co);
  const int chains = B * co;
  __syncthreads();  // every warp is done with the regeneration scratch
  for (int q = t; q < chains; q += THREADS) {
    acc_s[q] = 0.0f;
    part_s[q] = 0.0f;
  }
  for (int i0 = 0; i0 < g.d_in; i0 += R) {
    __syncthreads();  // the tile is complete, the last step walked
    const int rows = min(R, g.d_in - i0);
    for (int b = 0; b < B; ++b) {
      const float* xrow = X + static_cast<long long>(b) * g.d_in + i0;
      for (int ii = t; ii < R; ii += THREADS) xs[b * R + ii] = ii < rows ? xrow[ii] : 0.0f;
    }
    if constexpr (!ALL_FLUSH) {
      for (int q = t; q < R * co; q += THREADS) {
        const int j = q / R, ii = q - j * R, i = i0 + ii;
        const uint32_t r = g.row_offset + static_cast<uint32_t>(i) * g.d_out + o0 + j;
        flush[q] = ii < rows && (i == g.d_in - 1 ||
                                 block_of(r, rpw, g) != block_of(r + g.d_out, rpw, g));
      }
    }
    __syncthreads();
    for (int q = t; q < chains; q += THREADS) {
      const int b = q >> p.co_shift, j = q & (co - 1);
      const int o = o0 + j;
      if (o >= g.d_out) continue;
      const float* xb = xs + b * R;
      const float* wj = sW + j * (p.rows + 4) + i0;
      float acc = acc_s[q];
      if constexpr (ALL_FLUSH) {
        const int rv = (rows + 7) & ~7;  // rows past d_in add +0
#pragma unroll 2
        for (int ii = 0; ii < rv; ii += 4) {
          const float4 w4 = *reinterpret_cast<const float4*>(wj + ii);
          const float4 x4 = *reinterpret_cast<const float4*>(xb + ii);
          acc = __fadd_rn(acc, __fmul_rn(x4.x, w4.x));
          acc = __fadd_rn(acc, __fmul_rn(x4.y, w4.y));
          acc = __fadd_rn(acc, __fmul_rn(x4.z, w4.z));
          acc = __fadd_rn(acc, __fmul_rn(x4.w, w4.w));
        }
      } else {
        float part = part_s[q];
        const unsigned char* fj = flush + j * R;
        for (int ii = 0; ii < rows; ++ii) {
          part = __fadd_rn(part, __fmul_rn(xb[ii], wj[ii]));
          if (fj[ii]) {
            acc = __fadd_rn(acc, part);
            part = 0.0f;
          }
        }
        part_s[q] = part;
      }
      acc_s[q] = acc;
    }
  }
  __syncthreads();
  for (int q = t; q < chains; q += THREADS) {
    const int b = q >> p.co_shift, o = o0 + (q & (co - 1));
    if (o < g.d_out) Y[static_cast<long long>(b) * g.d_out + o] = acc_s[q];
  }
}

// scratch: the group's mask bits (phase 1), then the tile counter
template <int KIND, int D, bool ALL_FLUSH>
__global__ void __launch_bounds__(THREADS, 3)
serve_matmul_kernel(const void* __restrict__ words, uint32_t step,
                    const float* __restrict__ X, float* __restrict__ Y, int B,
                    qz::SpecArgs s, GroupArgs g, Plan p, uint32_t* scratch) {
  extern __shared__ float smem[];
  __shared__ uint32_t vk[2 * D8];
  __shared__ int next_tile;
  float* sW = smem;                   // rows x co weights of a tile
  float* aux = smem + p.co * (p.rows + 4);  // regeneration, then walk scratch
  const int t = threadIdx.x;
  const uint32_t hq = qz::prefix2(s.seed, s.tensor_id);
  const uint32_t hm = qz::mask_prefix(s.seed, s.tensor_id, step);
  uint32_t* counter = scratch + (g.n_coords + 31u) / 32u;
  if constexpr (D == D8) draw_bits<KIND>(words, s, g, hm, scratch);
  if (blockIdx.x == 0 && t == 0) *counter = 0u;
  if (t < 2 * D8) vk[t] = qz::fmix32(qz::CTR_VAL + static_cast<uint32_t>(t) + qz::K1);
  cg::this_grid().sync();  // every bit drawn, the counter at 0
  for (;;) {
    if (t == 0) next_tile = static_cast<int>(atomicAdd(counter, 1u));
    __syncthreads();
    const int tile = next_tile;
    if (tile >= p.tiles) break;
    const int o0 = tile * p.co;
    if constexpr (D == D8) {
      regenerate_d8<KIND>(s, g, p, scratch, vk, hq, o0, sW,
                          reinterpret_cast<uint32_t*>(aux));
    } else {
      regenerate_any<KIND>(words, s, g, p, hq, hm, o0, sW);
    }
    walk<ALL_FLUSH>(X, Y, B, s.rows_per_window, g, p, o0, sW, aux);
  }
}

// Debug view of the same device functions: per row, its d in-window
// indices, mask bits and values, and its streamed weight.
template <int KIND>
__global__ void edges_kernel(const void* __restrict__ words, uint32_t step,
                             const long long* __restrict__ rows, int R,
                             qz::SpecArgs s, int* __restrict__ idx,
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
    bits[j * s.d + k] = qz::mask_bit<KIND>(words, hm, wbase + ix) ? 1 : 0;
    vals[j * s.d + k] = e.value(k, s.sigma);
  }
  w[j] = qz::edge_weight<KIND>(s, hq, hm, words, r);
}

// qz::log_unit, sqrt_nonneg, cos_small and gaussian_from_u32 against logf,
// sqrtf, cosf and their Box-Muller at every 24-bit uniform u = (k + 1) 2^-24:
// out[0..3] count the arguments where they differ in any bit.
__global__ void gauss_check_kernel(unsigned long long* __restrict__ out) {
  const uint32_t k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= (1u << 24)) return;
  const uint32_t u = k << 8;
  const float a = qz::u32_to_uniform(u);
  const float x = __fmul_rn(logf(a), -2.0f);
  const float c = __fmul_rn(a, qz::TWO_PI);
  const float ref = __fmul_rn(sqrtf(x), cosf(c));
  const uint32_t d[4] = {
      __float_as_uint(qz::log_unit(a)) != __float_as_uint(logf(a)),
      __float_as_uint(qz::sqrt_nonneg(x)) != __float_as_uint(sqrtf(x)),
      __float_as_uint(qz::cos_small(c)) != __float_as_uint(cosf(c)),
      __float_as_uint(qz::gaussian_from_u32(u, u)) != __float_as_uint(ref)};
  for (int i = 0; i < 4; ++i) {
    if (d[i]) atomicAdd(out + i, 1ull);
  }
}

// The cooperative grid of an instance at this shared memory: one CTA per
// slot the card holds (the attribute raised first where it passes 48 KB).
template <int KIND, int D, bool ALL_FLUSH>
cudaError_t grid_of(size_t smem, int* ctas) {
  auto* kernel = serve_matmul_kernel<KIND, D, ALL_FLUSH>;
  static size_t allowed = 48 * 1024;  // raised once per instance, as needed
  // the CTAs an SM holds at each shared memory asked about (a few sizes:
  // the engine's shapes at its batch sizes)
  static size_t fit_smem[16];
  static int fit_ctas[16];
  static int fits = 0;
  cudaError_t rc;
  if (smem > allowed) {
    rc = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
    if (rc != cudaSuccess) return rc;
    allowed = smem;
  }
  int fit = 0;
  for (int i = 0; i < fits && !fit; ++i) {
    if (fit_smem[i] == smem) fit = fit_ctas[i];
  }
  if (!fit) {
    rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&fit, kernel, THREADS, smem);
    if (rc != cudaSuccess) return rc;
    if (fits < 16) {
      fit_smem[fits] = smem;
      fit_ctas[fits++] = fit;
    }
  }
  int device = 0, sms = 0;
  rc = cudaGetDevice(&device);
  if (rc == cudaSuccess) rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (rc != cudaSuccess) return rc;
  *ctas = fit * sms;
  return *ctas > 0 ? cudaSuccess : cudaErrorInvalidConfiguration;  // no CTA fits an SM
}

// A cooperative launch on the grid of grid_of.
template <int KIND, int D, bool ALL_FLUSH>
cudaError_t launch(size_t smem, cudaStream_t st, const void* words,
                   uint32_t step, const float* X, float* Y, int B,
                   const qz::SpecArgs& s, const GroupArgs& g, const Plan& p,
                   uint32_t* scratch) {
  int ctas = 0;
  const cudaError_t rc = grid_of<KIND, D, ALL_FLUSH>(smem, &ctas);
  if (rc != cudaSuccess) return rc;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(ctas));
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, serve_matmul_kernel<KIND, D, ALL_FLUSH>, words,
                            step, X, Y, B, s, g, p, scratch);
}

template <int KIND, int D, bool ALL_FLUSH>
struct Launch {
  template <typename... A>
  static cudaError_t run(A... args) { return launch<KIND, D, ALL_FLUSH>(args...); }
};

template <int KIND, int D, bool ALL_FLUSH>
struct Grid {
  static cudaError_t run(size_t smem, int* ctas) { return grid_of<KIND, D, ALL_FLUSH>(smem, ctas); }
};

// F<KIND, D, ALL_FLUSH>::run(args...) for the instance the constants name.
template <template <int, int, bool> class F, typename... A>
cudaError_t dispatch(const ServeConsts& c, A... args) {
  const bool d8 = c.d == D8, all = c.all_flush != 0;
  switch (c.kind) {
    case qz::KIND_F32:
      return d8 ? (all ? F<qz::KIND_F32, D8, true>::run(args...) : F<qz::KIND_F32, D8, false>::run(args...))
                : (all ? F<qz::KIND_F32, 0, true>::run(args...) : F<qz::KIND_F32, 0, false>::run(args...));
    case qz::KIND_U8:
      return d8 ? (all ? F<qz::KIND_U8, D8, true>::run(args...) : F<qz::KIND_U8, D8, false>::run(args...))
                : (all ? F<qz::KIND_U8, 0, true>::run(args...) : F<qz::KIND_U8, 0, false>::run(args...));
    case qz::KIND_U16:
      return d8 ? (all ? F<qz::KIND_U16, D8, true>::run(args...) : F<qz::KIND_U16, D8, false>::run(args...))
                : (all ? F<qz::KIND_U16, 0, true>::run(args...) : F<qz::KIND_U16, 0, false>::run(args...));
    default:
      return cudaErrorInvalidValue;
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

// Y (B, d_out) = X (B, d_in) @ W_g for the group whose rows start at
// row_offset, with constants c; w0 and n_coords: the group's first window
// and its windows' coordinates; scratch holds ceil(n_coords / 32) + 1
// words.  Returns the cudaError_t of the launch (an attribute or a
// cooperative launch the card refuses included).
int qz_serve_matmul(const void* words, unsigned step, const float* X, float* Y,
                    int B, unsigned row_offset, unsigned w0, unsigned n_coords,
                    unsigned* scratch, const ServeConsts* c, void* stream) {
  if (c->co < 1 || (c->co & (c->co - 1)) || c->rows < c->d_in || c->rows % 8 ||
      c->chunk < 8 || c->chunk % 8) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const qz::SpecArgs s = spec_args(c->seed, c->tensor_id, c->window,
                                   c->rows_per_window, c->d, c->sigma);
  GroupArgs g;
  g.row_offset = row_offset;
  g.d_in = c->d_in;
  g.d_out = c->d_out;
  g.bpw = c->bpw;
  g.rpw = {c->rpw_m, c->rpw_s1, c->rpw_s2};
  g.bm = {c->bm_m, c->bm_s1, c->bm_s2};
  g.w0 = w0;
  g.n_coords = n_coords;
  Plan p;
  p.co = c->co;
  p.co_shift = __builtin_ctz(static_cast<unsigned>(c->co));
  p.tiles = (c->d_out + c->co - 1) / c->co;
  p.rows = c->rows;
  p.chunk = c->chunk;
  const cudaError_t rc = dispatch<Launch>(
      *c, static_cast<size_t>(c->smem), static_cast<cudaStream_t>(stream), words,
      static_cast<uint32_t>(step), X, Y, B, s, g, p, scratch);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  return static_cast<int>(cudaGetLastError());
}

// The grid (CTAs) that a launch with constants c takes, in *ctas.
int qz_serve_grid(const ServeConsts* c, int* ctas) {
  return static_cast<int>(dispatch<Grid>(*c, static_cast<size_t>(c->smem), ctas));
}

// out (4 counters, zeroed by the caller): see gauss_check_kernel.
int qz_gauss_check(unsigned long long* out, void* stream) {
  gauss_check_kernel<<<(1u << 24) / 256, 256, 0, static_cast<cudaStream_t>(stream)>>>(out);
  return static_cast<int>(cudaGetLastError());
}

int qz_edges(const void* words, int kind, unsigned step, const long long* rows,
             int R, unsigned seed, unsigned tensor_id, int window,
             unsigned rows_per_window, int d, float sigma, int* idx,
             unsigned char* bits, float* vals, float* w, void* stream) {
  const qz::SpecArgs s = spec_args(seed, tensor_id, window, rows_per_window, d, sigma);
  const int threads = 128;
  const dim3 grid((R + threads - 1) / threads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case qz::KIND_F32:
      edges_kernel<qz::KIND_F32><<<grid, threads, 0, st>>>(words, step, rows, R, s, idx, bits, vals, w);
      break;
    case qz::KIND_U8:
      edges_kernel<qz::KIND_U8><<<grid, threads, 0, st>>>(words, step, rows, R, s, idx, bits, vals, w);
      break;
    case qz::KIND_U16:
      edges_kernel<qz::KIND_U16><<<grid, threads, 0, st>>>(words, step, rows, R, s, idx, bits, vals, w);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
