// The training kernels for Hopper: the reconstruct forward (from explicit
// masks or drawn in the body), the transpose-plan backward, the scatter
// backward and the upload sample-pack.  Device functions (hash, Q-row regeneration, mask
// draw, quantized threshold, Box-Muller) come from qz_common.cuh, the
// code the serve kernel (qz_decode.cu) already holds bitwise against
// torch.
//
// reconstruct_window is the forward of four Pallas kernels of
// src/repro/kernels/qz_reconstruct.py.  W[k, r] = sum_j vals[r, j] *
// z_k[idx[r, j]] in ascending j, each multiply and add rounded on its
// own, with z_k either
//   - drawn in the body, z_k ~ Bern(p_k) from the hash stream at the
//     coordinate (f32 probabilities, or the u8/u16 threshold compare):
//     sample_reconstruct_window_kernel, replacing
//     qz_sample_reconstruct_batched_fwd and, at K = 1,
//     qz_sample_reconstruct_fwd;
//   - read from an explicit (K, n) f32 operand (masks, or the
//     probabilities themselves in continuous mode):
//     mask_reconstruct_window_kernel, replacing qz_reconstruct_batched_fwd
//     and, at K = 1, qz_reconstruct_fwd.
// Window w's rows read only its `window` coordinates, so a CTA owns one
// window, or a slice of its rows where the leaf has too few windows to
// fill the card (each slice stages the window again); the geometry is
// reconstruct_geometry of kernels/qz_reconstruct.py.  For a sweep of
// `clients` clients at a time (one sweep wherever they fit):
//   1. a thread per (coordinate, word of 32 clients), coordinate fastest,
//      so each client's reads are coalesced: per client of the word the
//      bit (drawn once per (client, coordinate) with qz::mask_bit, so the
//      bits are kernel 10's and the plain _draw's), or the operand staged
//      in shared memory and its bit set where it is not +-0; the word goes
//      to shared memory;
//   2. a thread per (row, group of G clients), row fastest so the writes
//      of W are coalesced: the row's edges in batches of FWD_EDGE_ILP
//      (then one at a time), per edge its in-window index and the group's
//      bits there; a batch with none set is skipped, else its values (two
//      hashes past the slot's mixed counters, and Box-Muller) are
//      regenerated together, as independent chains, and added in
//      ascending j to the sums, in registers (G a template argument, 1,
//      4, 8, 16 or 32), of the clients whose bit is set (a drawn operand,
//      or an explicit one whose staged window holds only +0 and 1, found
//      by a CTA-wide vote, since value * 1 == value), or times the operand
//      to every live client's sum (any other explicit operand).  Every
//      edge is regenerated once per group, so once wherever K <= 32.
// Skipped edges are zero products, and a zero product changes no sum
// once a product that is not 0 has been added (x + -0 = x, and a sum
// that cancels to +0 stays +0), nor before it (-0 + x = x).  So each sum
// is the plain sum's bit for bit, except where every product of the
// (row, client) is +-0: then the plain sum is -0 exactly when every
// product is -0, and the thread recomputes the row's values until one
// product's sign is + (a product's sign is the value's sign XOR the
// operand's; a drawn operand is +0 or 1, so there one positive value
// already regenerated settles it).
// Bound: the larger of the operations (per row its two row hashes, per
// edge its index and, where some client's operand is not 0, its value;
// per (client, coordinate) one mask hash and compare; per (client, edge)
// whose operand is not 0 an add) and the bytes (the K operand rows read,
// the K output rows written): bytes at Fig. 4's leaves with K = 10,
// operations at K = 1 and at the full-width LM with K = 4.
//
// plan_bwd_kernel replaces qz_reconstruct_batched_bwd_plan and, launched
// at K = 1, qz_reconstruct_bwd_plan (every local backward, and each
// rank's in the sharded round): out[k] = Q^T G[k] over the plan's compact
// layout (core.transpose_plan.build_plan_layout): only the m*d real
// entries, in the plan's order (canonical or slot), coordinate c's list
// [starts[c], starts[c+1]), the window-local row as uint16 where
// rows_per_window allows.  A window's entries are one contiguous slab.
// One CTA owns one window.  It stages a piece of the slab at a time,
// once for all K clients, and beside it the window's cotangents of
// `stage` clients at a time (where a client's fit; each client's rows at
// an odd stride), all with cp.async, so a thread has every copy of a
// stage in flight at once; stages loop inside the kernel, so any K up to
// MAX_K takes one launch.  A thread takes a (coordinate, group of G
// clients) pair, coordinate fastest: it reads each entry of the
// coordinate's list once and adds it to G sums held in registers (G a
// template argument, 1, 2, 4 or 8), G independent chains.  Each sum runs
// over its list from +0 (or the partial sum it wrote for the previous
// piece), each multiply and add rounded on its own.  The padded plan's
// padding entries add 0 * g[the window's row 0], which is +-0 and changes
// no sum begun at +0 while that cotangent is finite; where it is Inf or
// NaN the padded walk (the plain version) gives NaN at every padded
// coordinate of the window and this walk does not.  Bound: bytes (6 bytes a real entry with
// uint16 rows, the offsets, K cotangents and K outputs).
//
// scatter_bwd_kernel replaces qz_reconstruct_batched_bwd (the scatter
// transpose: the round's backward under REPRO_BWD_PLAN=scatter) and,
// launched at K = 1, qz_reconstruct_bwd (the local backward under it):
// out[k] = Q^T G[k] with Q regenerated in the body, no plan read and none
// held.  Window w's rows write only into its coordinates, so a CTA owns
// one window and nothing crosses CTAs.  It takes the window's valid rows
// a pass of chunk_rows rows at a time (at most SCATTER_EDGES edges of
// kernels/qz_reconstruct.py), for a sweep of `clients` clients at a time
// (one sweep where their cotangents and partial sums fit; each further
// sweep regenerates the window again); per pass
//   0. a thread per row: the sweep's cotangents of the row, read once and
//      coalesced per client, into shared memory (a row's clients
//      contiguous, so the walk reads a group's with vector loads, with its
//      base and inverse as one 8-byte pair); a row is live where some
//      client's cotangent is not 0 (a row that is 0 for every client adds
//      only zeros); a live row's hash state, base | stride << 16 and the
//      stride's inverse mod the window, and its place in the pass's list
//      of live rows (a warp's live rows take places by one atomic; their
//      order there is free, the sums do not read it);
//   1. a thread per edge of the live rows (e = i * d + j): the edge's
//      value (its slot's counter mixes hoisted) into shared memory at e,
//      and the row's bit in the coordinate's row mask (an atomic OR: the
//      mask does not depend on the order of the ORs);
//   2. a thread per (coordinate, client group of G) walks the set bits of
//      the coordinate's mask in ascending row i; row i reaches coordinate
//      c at one slot only, j = (c - base) * stride^-1 mod window, so each
//      client k of the group adds value * g_k[i], the product rounded on
//      its own, to its sum: ascending (row, j), the canonical order, by
//      construction.  The G sums stay in registers (G a template
//      argument, 1, 2, 4 or 8); between passes of a window they wait in
//      shared memory, and the last pass writes them out.
// A row that is live for one client and 0 for another adds value * +-0
// to the second's sum, which changes no bit of a sum begun at +0 (such a
// sum is never -0).  So each sum is the canonical plan's sequence of
// rounded adds without its padding entries and equals plan_bwd_kernel's
// on the canonical plan bit for bit.  No sort, no scan, no atomic touches
// a sum.  A
// pass with no live row only reads its cotangents.  The Pallas kernel
// forms the same sum as a one-hot MXU product per row block; a product
// on the tensor cores would round to TF32, so this is a gather.
// Bound: operations where the cotangent is dense (an edge's index, two
// value hashes past their slot's mixed counter, and a Box-Muller), bytes
// where most rows carry none (an embedding's: G is read whole to find the
// live rows, which alone are regenerated).
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

// sample_pack_kernel: threads per CTA
constexpr int THREADS = 128;

// The explicit f32 operand of mask_reconstruct_window_kernel: no draw.
constexpr int KIND_VALUES = 3;

template <int KIND>
__device__ __forceinline__ const void* client_words(const void* P, uint32_t k,
                                                    uint32_t n) {
  const size_t off = static_cast<size_t>(k) * n;
  if (KIND == qz::KIND_F32 || KIND == KIND_VALUES) {
    return static_cast<const float*>(P) + off;
  }
  if (KIND == qz::KIND_U8) return static_cast<const uint8_t*>(P) + off;
  return static_cast<const uint16_t*>(P) + off;
}

// plan_bwd_kernel: threads per CTA (read by plan_geometry in
// kernels/qz_reconstruct.py)
constexpr int PLAN_THREADS = 256;

struct PlanArgs {
  const void* rows;   // (E,) window-local rows, uint16 or uint32
  const float* vals;  // (E,)
  const int* starts;  // (n + 1,) coordinate c's entries [starts[c], starts[c+1])
  uint32_t m, n;
  uint32_t window;
  uint32_t rows_per_window;
  int piece;  // slab entries staged at once
  int K;
  int stage;  // clients whose cotangents are staged at once
};

// 4 bytes from device to shared memory, asynchronously (cp.async): a
// thread issues all its copies of a stage before it waits for any.
__device__ __forceinline__ void copy_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(static_cast<uint32_t>(__cvta_generic_to_shared(dst))), "l"(src)
               : "memory");
}

__device__ __forceinline__ void copy_async_wait() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// A client's staged cotangent rows: rows_per_window at an odd stride.
__host__ __device__ __forceinline__ uint32_t plan_g_stride(uint32_t rows_per_window) {
  return rows_per_window | 1u;
}

// Dynamic shared memory: a piece's values, (STAGE_G) the staged clients'
// cotangents, the piece's rows (and one more 2-byte row, so uint16 rows
// copy as the 4-byte words that hold them).
__host__ __device__ __forceinline__ size_t plan_bytes(int piece, bool narrow,
                                                      bool stage_g, int stage,
                                                      uint32_t rows_per_window) {
  return static_cast<size_t>(piece) * (sizeof(float) + (narrow ? 2u : 4u)) + 4u
         + (stage_g ? sizeof(float) * static_cast<size_t>(stage)
                          * plan_g_stride(rows_per_window)
                    : 0u);
}

template <typename Row, bool STAGE_G, int G>
__global__ void __launch_bounds__(PLAN_THREADS)
plan_bwd_kernel(const float* __restrict__ Gm, PlanArgs a,
                float* __restrict__ out) {
  extern __shared__ uint32_t smem[];
  const uint32_t gs = plan_g_stride(a.rows_per_window);
  const uint32_t wmask = a.window - 1u, wshift = __ffs(a.window) - 1;
  float* sVal = reinterpret_cast<float*>(smem);
  float* sG = sVal + a.piece;
  Row* sRow = reinterpret_cast<Row*>(sG + (STAGE_G ? a.stage * gs : 0u));
  const Row* __restrict__ rows = static_cast<const Row*>(a.rows);
  const int t = threadIdx.x;
  const uint32_t c0 = blockIdx.x * a.window;
  const int s0 = a.starts[c0], s1 = a.starts[c0 + a.window];
  const uint32_t r0 = blockIdx.x * a.rows_per_window;
  const uint32_t nr = r0 < a.m ? min(a.rows_per_window, a.m - r0) : 0u;
  const float* __restrict__ gw = Gm + r0;
  for (int p0 = s0;; p0 += a.piece) {  // a window with no entry: one empty piece
    const int np = min(a.piece, s1 - p0);
    // the piece's values and rows; uint16 rows as the words that hold
    // them, so row e lies at sRow[off + e - p0]
    for (int i = t; i < np; i += PLAN_THREADS) copy_async4(sVal + i, a.vals + p0 + i);
    int off = 0;
    if (sizeof(Row) == 4) {
      for (int i = t; i < np; i += PLAN_THREADS) copy_async4(sRow + i, rows + p0 + i);
    } else {
      off = p0 & 1;
      const int w0 = p0 >> 1, w1 = (p0 + np) >> 1;  // words wholly before p0 + np
      const uint32_t* src = reinterpret_cast<const uint32_t*>(rows);
      uint32_t* dst = reinterpret_cast<uint32_t*>(sRow);
      for (int q = t; q < w1 - w0; q += PLAN_THREADS) copy_async4(dst + q, src + w0 + q);
      if (t == 0 && np > 0 && ((p0 + np) & 1)) sRow[off + np - 1] = rows[p0 + np - 1];
    }
    for (int k0 = 0; k0 < a.K; k0 += a.stage) {  // staged client groups
      const int kn = min(a.stage, a.K - k0);
      if (STAGE_G && (p0 == s0 || a.stage < a.K)) {  // else staged already
        for (int k = 0; k < kn; ++k) {
          const float* gk = gw + static_cast<size_t>(k0 + k) * a.m;
          for (uint32_t i = t; i < nr; i += PLAN_THREADS) copy_async4(sG + k * gs + i, gk + i);
        }
      }
      copy_async_wait();
      __syncthreads();
      // (coordinate, G clients) pairs, coordinate fastest
      const uint32_t pairs = a.window * ((kn + G - 1) / G);
      for (uint32_t q = t; q < pairs; q += PLAN_THREADS) {
        const uint32_t c = q & wmask;
        const int k1 = static_cast<int>(q >> wshift) * G;
        float* o = out + static_cast<size_t>(k0 + k1) * a.n + c0 + c;
        const int e1 = min(a.starts[c0 + c + 1], p0 + np);
        float acc[G];
#pragma unroll
        for (int g = 0; g < G; ++g) {
          acc[g] = p0 == s0 || k1 + g >= kn ? 0.0f : o[static_cast<size_t>(g) * a.n];
        }
        for (int e = max(a.starts[c0 + c], p0); e < e1; ++e) {
          const uint32_t row = sRow[off + e - p0];
          const float v = sVal[e - p0];
#pragma unroll
          for (int g = 0; g < G; ++g) {
            if (k1 + g < kn) {
              const float gv = STAGE_G ? sG[(k1 + g) * gs + row]
                                       : gw[static_cast<size_t>(k0 + k1 + g) * a.m + row];
              acc[g] = __fadd_rn(acc[g], __fmul_rn(v, gv));
            }
          }
        }
#pragma unroll
        for (int g = 0; g < G; ++g) {
          if (k1 + g < kn) o[static_cast<size_t>(g) * a.n] = acc[g];
        }
      }
      __syncthreads();  // the next group or piece reuses the shared memory
    }
    if (p0 + a.piece >= s1) break;
  }
}

// scatter_bwd_kernel: threads per CTA (read by scatter_geometry)
constexpr int SCATTER_THREADS = 256;

struct ScatterArgs {
  qz::SpecArgs s;
  uint32_t m, n;
  uint32_t K;
  uint32_t clients;      // clients a sweep
  uint32_t chunk_rows;   // rows a pass
  uint32_t mask_stride;  // words a coordinate's row mask takes, odd
  qz::Div div_d;         // / d
};

// Dynamic shared memory, in uint32 words from the start, each region's
// start a multiple of 4 words (16 bytes): per row of a pass the sweep's
// cotangents (the clients of a row contiguous, cl_pad of them, so a
// walking thread reads its G with vector loads) and base | stride << 16
// with the stride's inverse; where a window takes more than one pass the
// sweep's partial sums; per row its hash state and the live list; per
// edge its value; per slot j the mixed value counters; the coordinates'
// row masks; the live count.
struct ScatterLayout {
  size_t g, rs, acc, hr, list, val, ma, mb, mask, count, words;
};

__host__ __device__ __forceinline__ size_t up4(size_t x) { return (x + 3u) & ~size_t{3}; }

__host__ __device__ __forceinline__ uint32_t client_pad(uint32_t clients, int group) {
  return (clients + group - 1u) / group * group;
}

__host__ __device__ __forceinline__ ScatterLayout scatter_layout(
    uint32_t window, uint32_t rows_per_window, uint32_t mask_stride,
    uint32_t chunk_rows, int d, uint32_t clients, int group) {
  ScatterLayout L;
  const size_t cr = chunk_rows;
  L.g = 0;
  L.rs = L.g + up4(cr * client_pad(clients, group));
  L.acc = L.rs + up4(2u * cr);
  L.hr = L.acc + (rows_per_window > chunk_rows ? up4(size_t{clients} * window) : 0u);
  L.list = L.hr + up4(cr);
  L.val = L.list + up4(cr);
  L.ma = L.val + up4(cr * d);
  L.mb = L.ma + up4(d);
  L.mask = L.mb + up4(d);
  L.count = L.mask + up4(size_t{window} * mask_stride);
  L.words = L.count + 1u;
  return L;
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

// G cotangents of one row, contiguous and aligned to G floats.
template <int G>
__device__ __forceinline__ void load_g(const float* p, float (&g)[G]) {
  if (G % 4 == 0) {
#pragma unroll
    for (int h = 0; h < G; h += 4) {
      const float4 v = *reinterpret_cast<const float4*>(p + h);
      g[h] = v.x; g[h + 1] = v.y; g[h + 2] = v.z; g[h + 3] = v.w;
    }
  } else if (G == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    g[0] = v.x; g[G - 1] = v.y;
  } else {
    g[0] = p[0];
  }
}

template <int G>
__global__ void __launch_bounds__(SCATTER_THREADS)
scatter_bwd_kernel(const float* __restrict__ Gm, ScatterArgs a,
                   float* __restrict__ out) {
  extern __shared__ uint32_t smem[];  // 16-byte aligned
  const uint32_t window = a.s.window, wmask = window - 1u;
  const uint32_t wshift = __ffs(window) - 1;
  const uint32_t d = static_cast<uint32_t>(a.s.d);
  const uint32_t cr = a.chunk_rows;
  const uint32_t cl = client_pad(a.clients, G);
  const ScatterLayout L = scatter_layout(window, a.s.rows_per_window, a.mask_stride,
                                         cr, a.s.d, a.clients, G);
  float* sG = reinterpret_cast<float*>(smem + L.g);
  uint2* sRS = reinterpret_cast<uint2*>(smem + L.rs);  // base | stride << 16, inverse
  float* sAcc = reinterpret_cast<float*>(smem + L.acc);
  uint32_t* sHr = smem + L.hr;
  uint32_t* sList = smem + L.list;
  float* sVal = reinterpret_cast<float*>(smem + L.val);
  uint32_t* sMa = smem + L.ma;
  uint32_t* sMb = smem + L.mb;
  uint32_t* mask = smem + L.mask;
  uint32_t* sCount = smem + L.count;

  const uint32_t t = threadIdx.x, lane = t & 31u;
  const uint32_t r_lo = blockIdx.x * a.s.rows_per_window;
  const uint32_t r_hi = r_lo < a.m ? min(r_lo + a.s.rows_per_window, a.m) : r_lo;
  const uint32_t hq = qz::prefix2(a.s.seed, a.s.tensor_id);
  for (uint32_t j = t; j < d; j += SCATTER_THREADS) {
    sMa[j] = qz::fmix32(qz::CTR_VAL + 2u * j + qz::K1);
    sMb[j] = qz::fmix32(qz::CTR_VAL + 2u * j + 1u + qz::K1);
  }
  for (uint32_t k0 = 0; k0 < a.K; k0 += a.clients) {  // sweeps
    const uint32_t kn = min(a.clients, a.K - k0);
    const uint32_t pairs = window * ((kn + G - 1u) / G);
    bool fresh = true;  // no pass has summed yet: the sums start at +0
    bool dirty = true;  // the masks may hold bits
    for (uint32_t r0 = r_lo;; r0 += cr) {  // a window with no row: one empty pass
      const uint32_t nrows = r0 < r_hi ? min(cr, r_hi - r0) : 0u;
      const bool last = r0 + cr >= r_hi;
      if (dirty) {
        for (uint32_t i = t; i < window * a.mask_stride; i += SCATTER_THREADS) mask[i] = 0u;
      }
      if (t == 0) *sCount = 0u;
      __syncthreads();
      // 0. the pass's rows: cotangents, and the live rows' streams, listed
      for (uint32_t i0 = 0; i0 < nrows; i0 += SCATTER_THREADS) {
        const uint32_t i = i0 + t;
        bool live = false;
        if (i < nrows) {
          for (uint32_t k = 0; k < cl; ++k) {  // the padding clients read 0
            const float g = k < kn ? Gm[static_cast<size_t>(k0 + k) * a.m + r0 + i] : 0.0f;
            sG[i * cl + k] = g;
            live |= g != 0.0f;
          }
        }
        const uint32_t ballot = __ballot_sync(0xFFFFFFFFu, live);
        uint32_t at = 0u;
        if (lane == 0u && ballot) at = atomicAdd(sCount, __popc(ballot));
        at = __shfl_sync(0xFFFFFFFFu, at, 0);
        if (live) {
          const qz::RowEdges e = qz::row_edges(hq, r0 + i, window);
          uint32_t inv = e.stride;  // Newton: 3 -> 6 -> 12 -> 24 correct bits
          for (int it = 0; it < 3; ++it) inv *= 2u - e.stride * inv;
          sHr[i] = e.hr;
          sRS[i] = make_uint2(e.base | (e.stride << 16), inv);
          sList[at + __popc(ballot & ((1u << lane) - 1u))] = i;
        }
      }
      __syncthreads();
      const uint32_t nlive = *sCount;
      if (nlive == 0u && !last) {  // nothing to add: the masks stay 0
        dirty = false;
        continue;  // sCount stays 0, so its reset cannot race this read
      }
      // 1. the live rows' edges: value at e, row bit in the coordinate's mask
      for (uint32_t e = t; e < nlive * d; e += SCATTER_THREADS) {
        const uint32_t li = a.div_d(e), j = e - li * d;
        const uint32_t i = sList[li];
        const uint32_t bs = sRS[i].x;
        const uint32_t c = ((bs & 0xFFFFu) + (bs >> 16) * j) & wmask;
        sVal[i * d + j] = mixed_value(sHr[i], sMa[j], sMb[j], a.s.sigma);
        atomicOr(&mask[c * a.mask_stride + (i >> 5)], 1u << (i & 31u));
      }
      __syncthreads();
      // 2. each (coordinate, client group): its rows in ascending order
      const uint32_t words = (nrows + 31u) / 32u;
      for (uint32_t p = t; p < pairs; p += SCATTER_THREADS) {
        const uint32_t c = p & wmask, k1 = (p >> wshift) * G;
        float acc[G];
#pragma unroll
        for (int g = 0; g < G; ++g) {
          acc[g] = fresh || k1 + g >= kn ? 0.0f : sAcc[(k1 + g) * window + c];
        }
        for (uint32_t w = 0; w < words; ++w) {
          for (uint32_t bits = mask[c * a.mask_stride + w]; bits; bits &= bits - 1u) {
            const uint32_t i = 32u * w + (__ffs(bits) - 1);
            const uint2 rs = sRS[i];
            const uint32_t j = ((c - (rs.x & 0xFFFFu)) * rs.y) & wmask;
            const float v = sVal[i * d + j];
            float g[G];
            load_g<G>(sG + i * cl + k1, g);
#pragma unroll
            for (int h = 0; h < G; ++h) acc[h] = __fadd_rn(acc[h], __fmul_rn(v, g[h]));
          }
        }
#pragma unroll
        for (int g = 0; g < G; ++g) {
          if (k1 + g >= kn) continue;
          if (last) {
            out[static_cast<size_t>(k0 + k1 + g) * a.n + blockIdx.x * window + c] = acc[g];
          } else {
            sAcc[(k1 + g) * window + c] = acc[g];
          }
        }
      }
      fresh = false;
      dirty = true;
      __syncthreads();  // the next pass or sweep reuses the shared memory
      if (last) break;
    }
  }
}

// reconstruct_window: threads per CTA (read by reconstruct_geometry in
// kernels/qz_reconstruct.py), and the edges of a row whose values a
// thread regenerates together (independent chains in flight)
constexpr int FWD_THREADS = 256;
constexpr int FWD_EDGE_ILP = 4;

struct FwdArgs {
  qz::SpecArgs s;
  uint32_t m, n;
  uint32_t K;
  uint32_t slices;   // CTAs a window
  uint32_t rows;     // a window's rows a CTA (the last slice may hold fewer)
  uint32_t clients;  // clients a sweep
};

// Dynamic shared memory, in 4-byte words: per slot j the mixed value
// counters (2 d); the sweep's mask prefixes (drawn kinds); per (client
// word, coordinate) the word of bits; the sweep's operands, a client's
// window at a time (explicit operand).
__host__ __device__ __forceinline__ size_t fwd_words(int d, uint32_t window,
                                                     uint32_t clients,
                                                     bool values) {
  const size_t cw = (clients + 31u) / 32u;
  return 2u * static_cast<size_t>(d) + (values ? 0u : clients) + cw * window
         + (values ? static_cast<size_t>(clients) * window : 0u);
}

// Phase 2's work on one row for a group of G clients (nlive of them
// below the sweep's end): its edges U at a time from j0, each edge's
// in-window index and the group's bits there (a drawn bit, or an operand
// that is not +-0).  A batch with no bit set adds only zero products and
// is skipped; else its values are regenerated together, as independent
// chains, and added in ascending j.  BITS: the operands are the bits
// themselves (drawn, or explicit and all +0 or 1, where value * 1 ==
// value): a value goes to the sums of the clients whose bit is set, and
// `neg` keeps whether every value regenerated so far is negative.  Else
// value * operand goes to every live client's sum, the operands loaded
// together (a +-0 product changes no sum).
template <bool BITS, int G, int U>
__device__ __forceinline__ void window_edges(const qz::RowEdges& e, int j0,
                                             const uint32_t* __restrict__ bw, uint32_t sh,
                                             int nlive, const float* __restrict__ sZg,
                                             const uint32_t* __restrict__ sMa,
                                             const uint32_t* __restrict__ sMb,
                                             uint32_t window, float sigma,
                                             float (&acc)[G], uint32_t& neg) {
  constexpr uint32_t GMASK = G == 32 ? 0xFFFFFFFFu : (1u << G) - 1u;
  uint32_t c[U], bits[U], any = 0u;
#pragma unroll
  for (int u = 0; u < U; ++u) {
    c[u] = e.index(j0 + u, window);
    bits[u] = (bw[c[u]] >> sh) & GMASK;  // G divides 32: one word
    any |= bits[u];
  }
  if (any == 0u) return;
  float v[U];
#pragma unroll
  for (int u = 0; u < U; ++u) v[u] = mixed_value(e.hr, sMa[j0 + u], sMb[j0 + u], sigma);
#pragma unroll
  for (int u = 0; u < U; ++u) {
    if (BITS) {
      neg &= __float_as_uint(v[u]) >> 31;
#pragma unroll
      for (int g = 0; g < G; ++g) {
        if ((bits[u] >> g) & 1u) acc[g] = __fadd_rn(acc[g], v[u]);
      }
    } else {
      float z[G];
#pragma unroll
      for (int g = 0; g < G; ++g) z[g] = g < nlive ? sZg[g * window + c[u]] : 0.0f;
#pragma unroll
      for (int g = 0; g < G; ++g) acc[g] = __fadd_rn(acc[g], __fmul_rn(v[u], z[g]));
    }
  }
}

// Phase 2 for one group of G clients: a thread a row of the CTA's slice,
// row fastest, each client's sum from -0 in ascending j (window_edges);
// where every product of a (row, client) is +-0, the sign rule.  Wg: the
// group's first client's row of W.
template <bool BITS, int G>
__device__ __forceinline__ void window_rows(const FwdArgs& a, uint32_t hq, uint32_t r_lo,
                                            uint32_t nrows, const uint32_t* __restrict__ bw,
                                            uint32_t sh, int nlive,
                                            const float* __restrict__ sZg,
                                            const uint32_t* __restrict__ sMa,
                                            const uint32_t* __restrict__ sMb,
                                            float* __restrict__ Wg) {
  const uint32_t window = a.s.window;
  const int d = a.s.d;
  const uint32_t live = nlive >= G ? 0xFFFFFFFFu : (1u << nlive) - 1u;
  for (uint32_t i = threadIdx.x; i < nrows; i += FWD_THREADS) {
    const uint32_t r = r_lo + i;
    const qz::RowEdges e = qz::row_edges(hq, r, window);
    float acc[G];
#pragma unroll
    for (int g = 0; g < G; ++g) acc[g] = -0.0f;  // -0 + x == x for every x
    uint32_t neg = 1u;
    int j0 = 0;
    for (; j0 + FWD_EDGE_ILP <= d; j0 += FWD_EDGE_ILP) {
      window_edges<BITS, G, FWD_EDGE_ILP>(e, j0, bw, sh, nlive, sZg, sMa, sMb, window,
                                          a.s.sigma, acc, neg);
    }
    for (; j0 < d; ++j0) {
      window_edges<BITS, G, 1>(e, j0, bw, sh, nlive, sZg, sMa, sMb, window, a.s.sigma, acc,
                               neg);
    }
    // a (row, client) whose products were all +-0: -0 iff all are -0.  A
    // product's sign is the value's XOR the operand's; with BITS the
    // value's, so one positive value regenerated above decides (+0).
    uint32_t need = 0u;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      if (((live >> g) & 1u) && acc[g] == 0.0f) need |= 1u << g;
    }
    if (BITS && neg == 0u) need = 0u;
    for (int j = 0; need != 0u && j < d; ++j) {
      const uint32_t c = e.index(j, window);
      const uint32_t sv = __float_as_uint(mixed_value(e.hr, sMa[j], sMb[j], a.s.sigma)) >> 31;
      if (BITS) {
        if (sv == 0u) need = 0u;
      } else {
#pragma unroll
        for (int g = 0; g < G; ++g) {
          if (((need >> g) & 1u) && (__float_as_uint(sZg[g * window + c]) >> 31) == sv) {
            need &= ~(1u << g);
          }
        }
      }
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      if ((live >> g) & 1u) {
        Wg[static_cast<size_t>(g) * a.m + r] =
            ((need >> g) & 1u) ? -0.0f : acc[g] == 0.0f ? 0.0f : acc[g];
      }
    }
  }
}

template <int KIND, int G>
__device__ __forceinline__ void reconstruct_window(const void* __restrict__ P,
                                                   const long long* __restrict__ steps,
                                                   const FwdArgs& a,
                                                   float* __restrict__ W) {
  constexpr bool DRAWN = KIND != KIND_VALUES;
  extern __shared__ uint32_t smem[];
  const uint32_t window = a.s.window, wshift = __ffs(window) - 1;
  const int d = a.s.d;
  const uint32_t cw = (a.clients + 31u) / 32u;
  uint32_t* sMa = smem;
  uint32_t* sMb = sMa + d;
  uint32_t* sHm = sMb + d;
  uint32_t* sBits = sHm + (DRAWN ? a.clients : 0u);
  float* sZ = reinterpret_cast<float*>(sBits + cw * window);

  const uint32_t w = blockIdx.x / a.slices;
  const uint32_t r_win = w * a.s.rows_per_window;
  const uint32_t r_lo = r_win + (blockIdx.x - w * a.slices) * a.rows;
  const uint32_t r_end = min(r_win + a.s.rows_per_window, a.m);
  if (r_lo >= r_end) return;  // an empty slice (a ragged or empty last window)
  const uint32_t nrows = min(a.rows, r_end - r_lo);
  const uint32_t wbase = w * window;
  const uint32_t t = threadIdx.x;
  const uint32_t hq = qz::prefix2(a.s.seed, a.s.tensor_id);
  for (int j = t; j < d; j += FWD_THREADS) {
    sMa[j] = qz::fmix32(qz::CTR_VAL + 2u * j + qz::K1);
    sMb[j] = qz::fmix32(qz::CTR_VAL + 2u * j + 1u + qz::K1);
  }
  for (uint32_t k0 = 0; k0 < a.K; k0 += a.clients) {  // sweeps
    const uint32_t kn = min(a.clients, a.K - k0);
    if (DRAWN) {
      for (uint32_t k = t; k < kn; k += FWD_THREADS) {
        sHm[k] = qz::mask_prefix(a.s.seed, a.s.tensor_id,
                                 static_cast<uint32_t>(steps[k0 + k]));
      }
      __syncthreads();
    }
    // 1. each (coordinate, client word): the clients' bits, drawn or read
    const uint32_t words = (kn + 31u) / 32u;
    bool binary = true;  // every operand this thread staged is +0 or 1
    for (uint32_t q = t; q < words * window; q += FWD_THREADS) {
      const uint32_t c = q & (window - 1u), wi = q >> wshift;
      const uint32_t kb = 32u * wi, ke = min(kb + 32u, kn);
      uint32_t word = 0u;
      for (uint32_t k1 = kb; k1 < ke; k1 += G) {  // G clients' loads in flight
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const uint32_t k = k1 + g;
          if (k < ke) {
            const void* pk = client_words<KIND>(P, k0 + k, a.n);
            bool bit;
            if (DRAWN) {
              bit = qz::mask_bit<DRAWN ? KIND : qz::KIND_F32>(pk, sHm[k], wbase + c);
            } else {
              const float z = static_cast<const float*>(pk)[wbase + c];
              sZ[k * window + c] = z;
              bit = z != 0.0f;
              binary &= __float_as_uint(z) == 0u || z == 1.0f;
            }
            word |= static_cast<uint32_t>(bit) << (k - kb);
          }
        }
      }
      sBits[wi * window + c] = word;
    }
    // an explicit operand of masks (all +0 or 1) takes the bits' path
    bool masks = true;
    if (DRAWN) {
      __syncthreads();
    } else {
      masks = __syncthreads_and(binary) != 0;
    }
    // 2. each group of G clients
    for (uint32_t kg = 0; kg < kn; kg += G) {
      const uint32_t* bw = sBits + (kg >> 5) * window;
      const int nlive = kn - kg >= G ? G : static_cast<int>(kn - kg);
      float* Wg = W + static_cast<size_t>(k0 + kg) * a.m;
      const float* sZg = sZ + kg * window;
      if constexpr (DRAWN) {
        window_rows<true, G>(a, hq, r_lo, nrows, bw, kg & 31u, nlive, sZg, sMa, sMb, Wg);
      } else if (masks) {
        window_rows<true, G>(a, hq, r_lo, nrows, bw, kg & 31u, nlive, sZg, sMa, sMb, Wg);
      } else {
        window_rows<false, G>(a, hq, r_lo, nrows, bw, kg & 31u, nlive, sZg, sMa, sMb, Wg);
      }
    }
    __syncthreads();  // the next sweep restages the shared memory
  }
}

template <int KIND, int G>
__global__ void __launch_bounds__(FWD_THREADS)
sample_reconstruct_window_kernel(const void* __restrict__ P,
                                 const long long* __restrict__ steps, FwdArgs a,
                                 float* __restrict__ W) {
  reconstruct_window<KIND, G>(P, steps, a, W);
}

template <int G>
__global__ void __launch_bounds__(FWD_THREADS)
mask_reconstruct_window_kernel(const float* __restrict__ Z, FwdArgs a,
                               float* __restrict__ W) {
  reconstruct_window<KIND_VALUES, G>(Z, nullptr, a, W);
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

// The forward's kernels for client group 1, 4, 8, 16 or 32 (g = 0..4).
template <int KIND>
void (*sample_fwd_kernel(int g))(const void*, const long long*, FwdArgs, float*) {
  return g == 0 ? sample_reconstruct_window_kernel<KIND, 1>
       : g == 1 ? sample_reconstruct_window_kernel<KIND, 4>
       : g == 2 ? sample_reconstruct_window_kernel<KIND, 8>
       : g == 3 ? sample_reconstruct_window_kernel<KIND, 16>
                : sample_reconstruct_window_kernel<KIND, 32>;
}

void (*mask_fwd_kernel(int g))(const float*, FwdArgs, float*) {
  return g == 0 ? mask_reconstruct_window_kernel<1> : g == 1 ? mask_reconstruct_window_kernel<4>
       : g == 2 ? mask_reconstruct_window_kernel<8> : g == 3 ? mask_reconstruct_window_kernel<16>
                : mask_reconstruct_window_kernel<32>;
}

// plan_bwd_kernel for client group 1, 2, 4 or 8 (g = 0..3).
template <typename Row, bool STAGE_G>
void (*plan_kernel(int g))(const float*, PlanArgs, float*) {
  return g == 0 ? plan_bwd_kernel<Row, STAGE_G, 1> : g == 1 ? plan_bwd_kernel<Row, STAGE_G, 2>
       : g == 2 ? plan_bwd_kernel<Row, STAGE_G, 4> : plan_bwd_kernel<Row, STAGE_G, 8>;
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

// A leaf's launch constants for scatter_bwd_kernel at K clients, made
// once by the wrapper (kernels/qz_reconstruct.py, scatter_geometry) and
// passed by pointer.
struct ScatterConsts {
  unsigned seed, tensor_id;
  int window;
  unsigned rows_per_window;
  int d;
  float sigma;
  unsigned m, n, num_windows, K, clients, group, chunk_rows, mask_stride,
      div_m, div_s1, div_s2;
  int smem;
};

// A leaf's launch constants for plan_bwd_kernel on one card: its compact
// plan layout there and the geometry that does not depend on K
// (plan_geometry).
struct PlanConsts {
  const void* rows;
  const float* vals;
  const int* starts;
  unsigned m, n, window, rows_per_window, num_windows;
  int piece, narrow, stage_g;
};

// A leaf's launch constants for reconstruct_window at K clients, made
// once by the wrapper (kernels/qz_reconstruct.py, reconstruct_geometry)
// and passed by pointer.
struct FwdConsts {
  unsigned seed, tensor_id;
  int window;
  unsigned rows_per_window;
  int d;
  float sigma;
  unsigned m, n, num_windows, K, slices, rows, clients, group;
  int values, smem;
};

namespace {

// The forward's arguments from its launch constants, checked for what
// the body needs: a power-of-two window, slices that cover a window's
// rows, a sweep of at most K clients, a group the body is built for
// (its index g), the shared memory of its layout, a grid that launches.
int fwd_args(const FwdConsts* c, bool values, FwdArgs& a, int& g) {
  const uint32_t w = static_cast<uint32_t>(c->window);
  const unsigned G = c->group;
  g = G == 1 ? 0 : G == 4 ? 1 : G == 8 ? 2 : G == 16 ? 3 : G == 32 ? 4 : -1;
  if (c->window < 2 || (w & (w - 1)) || c->d < 1 || c->K < 1 || c->clients < 1 ||
      c->clients > c->K || g < 0 || c->rows < 1 || c->slices < 1 ||
      static_cast<uint64_t>(c->slices) * c->rows < c->rows_per_window ||
      static_cast<uint64_t>(c->slices) * c->num_windows >= (1ull << 31) ||
      c->values != static_cast<int>(values) ||
      static_cast<size_t>(c->smem) != 4 * fwd_words(c->d, w, c->clients, values)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  a.s = spec_args(c->seed, c->tensor_id, c->window, c->rows_per_window, c->d, c->sigma);
  a.m = c->m;
  a.n = c->n;
  a.K = c->K;
  a.slices = c->slices;
  a.rows = c->rows;
  a.clients = c->clients;
  return 0;
}

}  // namespace

extern "C" {

// W (K, m) = Q Bern(P_k) for the K clients' operands P (K, n) of kind
// `kind` (f32, u8 or u16), drawn at words `steps` (K,).
int qz_sample_reconstruct(const void* P, int kind, const long long* steps,
                          float* W, const FwdConsts* c, void* stream) {
  FwdArgs a;
  int g;
  const int rc = fwd_args(c, false, a, g);
  if (rc != 0) return rc;
  if (kind < qz::KIND_F32 || kind > qz::KIND_U16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto kernel = kind == qz::KIND_F32 ? sample_fwd_kernel<qz::KIND_F32>(g)
              : kind == qz::KIND_U8  ? sample_fwd_kernel<qz::KIND_U8>(g)
                                     : sample_fwd_kernel<qz::KIND_U16>(g);
  static int opted[3][5] = {};
  const cudaError_t err = allow_smem(kernel, c->smem, opted[kind][g]);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<c->num_windows * c->slices, FWD_THREADS, c->smem,
           static_cast<cudaStream_t>(stream)>>>(P, steps, a, W);
  return static_cast<int>(cudaGetLastError());
}

// W (K, m) = Q Z_k for the K clients' explicit operands Z (K, n).
int qz_reconstruct_batched(const float* Z, float* W, const FwdConsts* c,
                           void* stream) {
  FwdArgs a;
  int g;
  const int rc = fwd_args(c, true, a, g);
  if (rc != 0) return rc;
  auto kernel = mask_fwd_kernel(g);
  static int opted[5] = {};
  const cudaError_t err = allow_smem(kernel, c->smem, opted[g]);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<c->num_windows * c->slices, FWD_THREADS, c->smem,
           static_cast<cudaStream_t>(stream)>>>(Z, a, W);
  return static_cast<int>(cudaGetLastError());
}

// out (K, n) = Q^T G_k over the compact plan layout; G (K, m) moved
// order, K clients staged `stage` at a time and summed `group` (1, 2, 4
// or 8) a thread (plan_geometry's, with its shared memory, for this K).
int qz_plan_bwd(const float* G, float* out, int K, int stage, int group,
                int smem, const PlanConsts* c, void* stream) {
  const uint32_t w = c->window;
  if (c->piece < 1 || w < 2 || (w & (w - 1)) || K < 1 || stage < 1 ||
      stage > K || (!c->stage_g && stage != K) ||
      static_cast<size_t>(smem) !=
          plan_bytes(c->piece, c->narrow, c->stage_g, stage, c->rows_per_window)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  PlanArgs a;
  a.rows = c->rows;
  a.vals = c->vals;
  a.starts = c->starts;
  a.m = c->m;
  a.n = c->n;
  a.window = c->window;
  a.rows_per_window = c->rows_per_window;
  a.piece = c->piece;
  a.K = K;
  a.stage = stage;
  const int g = group == 1 ? 0 : group == 2 ? 1 : group == 4 ? 2 : group == 8 ? 3 : -1;
  if (g < 0) return static_cast<int>(cudaErrorInvalidValue);
  const int which = (c->narrow ? 8 : 0) + (c->stage_g ? 4 : 0) + g;
  auto kernel = c->narrow ? (c->stage_g ? plan_kernel<uint16_t, true>(g)
                                        : plan_kernel<uint16_t, false>(g))
                          : (c->stage_g ? plan_kernel<uint32_t, true>(g)
                                        : plan_kernel<uint32_t, false>(g));
  static int opted[16] = {};
  const cudaError_t err = allow_smem(kernel, smem, opted[which]);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<c->num_windows, PLAN_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      G, a, out);
  return static_cast<int>(cudaGetLastError());
}

// out (K, n) = Q^T G_k by the scatter, Q regenerated; G (K, m) moved order.
int qz_scatter_bwd(const float* G, float* out, const ScatterConsts* c,
                   void* stream) {
  // the geometry is scatter_geometry's; checked here is what the body
  // needs: a power-of-two window whose base | stride << 16 packs into 32
  // bits, a row mask of a pass's rows, a sweep of at most K clients, a
  // client group the body is built for, shared memory of its layout
  const int w = c->window;
  if (w < 2 || w > 65536 || (w & (w - 1)) || c->d < 1 || c->chunk_rows < 1 ||
      32 * c->mask_stride < c->chunk_rows || c->K < 1 || c->clients < 1 ||
      c->clients > c->K || c->group < 1 ||
      static_cast<size_t>(c->smem) !=
          4 * scatter_layout(w, c->rows_per_window, c->mask_stride,
                             c->chunk_rows, c->d, c->clients,
                             static_cast<int>(c->group)).words) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  ScatterArgs a;
  a.s = spec_args(c->seed, c->tensor_id, w, c->rows_per_window, c->d, c->sigma);
  a.m = c->m;
  a.n = c->n;
  a.K = c->K;
  a.clients = c->clients;
  a.chunk_rows = c->chunk_rows;
  a.mask_stride = c->mask_stride;
  a.div_d = {c->div_m, c->div_s1, c->div_s2};
  const unsigned g = c->group;
  const int which = g == 1 ? 0 : g == 2 ? 1 : g == 4 ? 2 : g == 8 ? 3 : -1;
  if (which < 0) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = which == 0 ? scatter_bwd_kernel<1> : which == 1 ? scatter_bwd_kernel<2>
              : which == 2 ? scatter_bwd_kernel<4> : scatter_bwd_kernel<8>;
  static int opted[4] = {};
  const cudaError_t err = allow_smem(kernel, c->smem, opted[which]);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<c->num_windows, SCATTER_THREADS, c->smem,
           static_cast<cudaStream_t>(stream)>>>(G, a, out);
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
