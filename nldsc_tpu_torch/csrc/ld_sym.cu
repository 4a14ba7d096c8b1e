// Fused symmetric int8 LD kernel for Hopper (sm_90a): K1.
//
// Replaces nldsc_tpu/ld/ld_pallas_sym.py::_kernel (the TPU's fused
// symmetric Pallas kernel).  One CTA takes a pivot tile b and a
// neighbour tile t >= b of the right half-band, accumulates the exact
// int8 x int8 -> int32 products over the whole sample axis (Sgg, Sgh,
// Shg; plus Sgm, Smg, Smm, Smh, Shm when genotypes are missing) on the
// tensor cores, and runs the whole epilogue in registers: corr_from_dots,
// adjusted r^2, the window, usable, dom_ok and poison masks, and the row
// and mirrored column sums.
//
// What bounds it: int8 tensor-core operations, fed from L2.  Every
// operand byte a CTA loads feeds TILE products of each product matrix,
// so the tile sets the operations per byte of L2 traffic.  The design:
//   * products on wgmma (m64nNk32.s32.s8.s8) with both operands in
//     shared memory: the row-major (rows, samples) matrices are K-major
//     on both sides, as int8 wgmma requires;
//   * stacked neighbour operands, so that one wgmma yields several
//     products: clean, A = g_i against B = [g_j; h_j] gives Sgg|Sgh and
//     A = h_i against B = g_j gives Shg; missing, each consumer
//     warpgroup keeps B = [h_j; g_j; m_j] for its neighbour rows, which
//     A = g_i and A = m_i take whole and A = h_i takes as [g_j; m_j];
//   * a ring of shared-memory stages of KC = 128 bytes of each row (one
//     row of the 128-byte swizzle: 128 int8 samples, 64 bf16), filled
//     with TMA by one producer thread and handed over through
//     mbarriers; two consumer warpgroups issue the
//     wgmmas, and setmaxnreg moves registers from the producer
//     warpgroup to them;
//   * 128 x 128 tiles on the clean branch (192 accumulator registers a
//     consumer thread: each warpgroup takes 64 pivot rows), 64 x 64 on
//     the missing branch (8 products, 128 registers: each warpgroup
//     takes 32 neighbour rows);
//   * on wide rows, thread-block clusters of CP x CN = 2 x 2 CTAs: pivot
//     tiles b0, b0+1 against neighbour tiles t0, t0+1.  The CTAs of a
//     cluster that share a tile each load a share of its boxes and
//     multicast it to all of them (TMA .multicast::cluster), so a stage
//     costs each CTA half the L2 and HBM reads of its 64 KiB (clean; 48
//     KiB missing): 384 int8 operations per loaded byte instead of 192
//     (171 -> 341 missing), where the card needs 591 to be bound by its
//     tensor cores.  A slot is refilled once the consumers of every CTA it
//     lands in have released it (remote arrivals on each sender's empty
//     barrier), so the four CTAs stream the samples in step and the shared
//     tiles are read once at any width: at N = 300,032 a CTA streams 2,344
//     stages, and CTAs that run apart would each fetch the shared tiles
//     from HBM again.  A CTA whose slot lies outside the band still loads
//     its share for its peers and computes nothing; a cluster with no CTA
//     in the band exits at once.  The caller picks per launch between
//     clusters and the plain launch (ld_pallas_sym.cluster_shape): on
//     narrow rows, where L2 still serves CTAs that run apart, the
//     clusters' costs (120 of the 132 multiprocessors hold clusters of
//     four; dead members) outweigh the halved reads, and each CTA loads
//     its own tiles;
//   * neighbour tiles fastest in the grid, so that the CTAs, or clusters,
//     that start together share their pivot tile and most neighbours in
//     L2.
// No (tile x tile) correlation block is ever written: a CTA writes only
// its row and column partial sums, which a fixed-order reduction outside
// the kernel folds (no float atomics, so run-to-run results are bitwise
// equal).
//
// Partitioned LD scores (the ANNOT instantiations): the reference
// contracts each masked adjusted-r^2 tile with the annotation rows of its
// neighbours outside any kernel (nldsc_tpu/ld/ld_int8.py::sym_scan_segment,
// annot branch).  Here the tile never leaves the registers, so the
// epilogue stages the masked values it adds to the plain sums, the same
// floats, in the freed ring and contracts them on the tensor cores
// (annot_epilogue.cuh: tf32 hi + lo, three products) with the annotations
// of the neighbour rows (row credits) and of the pivot rows (mirrored
// column credits).  The missing branch stages its whole 64 x 64 tile and
// contracts it once.  The clean branch's 128 x 128 tile would need 192 KiB
// for its three value tiles, and the ring with the shared memory past it
// holds 212 KiB, of which the partial sums and the stashed Shg still take
// 91 KiB while the epilogue runs; so it stages two 64-column halves (102
// KiB each with the bank padding) and contracts each once: the mirrored
// column credits of a half are complete and written, the row credits stay
// in registers (ANNOT_ROW_MAX annotations, 2 x 52 a thread) across both
// halves and are written once.  A launch takes at most ANNOT_ROW_MAX
// annotations on the clean branch (the wrapper launches once per group of
// them).  Each chunk's annotation slabs are loaded once per half, into the
// stashed Shg's consumed first half and the shared memory past the ring.
// The plain sums and counters of an ANNOT launch are those of a plain
// launch bit for bit.
//
// bf16 operands (the BF16 instantiations, the reference's dot_dtype="bf16"
// branch, ld_pallas_sym.py:86-89 with float32 accumulators at :237): the
// same products as bf16 x bf16 -> f32 on wgmma.m64nNk16.f32.bf16.bf16.  A
// k16 bf16 product takes the 32 bytes of K an int8 k32 one takes, so the
// ring keeps its bytes, swizzle, descriptor steps and annotation staging;
// a stage holds 64 samples instead of 128, and the tensor maps are bf16.
// The codes are exact in bf16 and every partial sum is an integer below
// 2^24 (N_pad <= 2^22), so the f32 accumulators hold the int8 branch's
// sums exactly (the epilogue reads them as the same floats, the stashed
// Shg through acc_int); bounded by bf16 tensor-core operations at half the
// int8 rate.
//
// The TMA, mbarrier and wgmma helpers and the tensor-map encoding live in
// hopper.cuh, shared with K2 (split_corr.cu).
//
// The per-pair expressions live in pair_epilogue.cuh, shared with the
// split engine's delta epilogue (split_corr.cu).  They follow the float32
// operation order of corr_from_dots (nldsc_tpu_torch/ld/ld_int8.py);
// built with -fmad=false, each pair's values equal the plain twin's bit
// for bit, so the WSE threshold count agrees exactly.  The int32 sums are
// exact, and exact in float32: |S| <= 4 * N_pad <= 2^24.
//
// Layouts: g, m, h int8 (bf16 when BF16) (M_pad, N_pad) row-major, 16-byte
// aligned, N_pad a multiple of 128; scal f32 (M_pad, 9); lo, hi int32 (M_pad); usable,
// dom_ok, poison uint8 (M_pad); tile_hi int32 (M_pad / TILE), the last
// neighbour tile of each pivot tile.  Partial outputs (zero-filled by
// the caller):
//   fpart f32  [n_tiles][band][2 (row, col)][2 (l2, l2d)][TILE]
//   ipart int32[n_tiles][band][2 (row, col)][4 (ws, wsd, wse, poison)][TILE]
// and, with annot f32 (M_pad, ld) row-major (p <= ld of its columns),
//   apart f32  [n_tiles][band][2 (row, col)][2 (l2, l2d)][TILE][ld]
// of which annotations [0, p) are written, every slot of the first n_piv
// pivot tiles (zeros outside the band and in the pivot tile's column
// slots), so apart needs no fill.  CTAs of pivot tiles from n_piv on
// write nothing.
//
// Grid: x = CN x NJ neighbour tiles, NJ = ceil((band + CP - 1) / CN),
// y = CP x ceil(n_piv / CP) pivot tiles; CTA (j, b) of cluster (t0, b0)
// takes pivot tile b and neighbour tile t = t0 + j % CN, t0 = b0 + CN x
// (j / CN), b0 = b rounded down to a multiple of CP, and owns slot k = t - b
// of pivot tile b when b < n_piv and 0 <= k < band.  So every slot of
// every pivot tile below n_piv has exactly one owner
// (ld_pallas_sym.cluster_tile_ctas counts the grid's CTAs).  Out of clusters
// (CP = CN = 1) this is the grid (band, n_piv) of one CTA per slot.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>

#include "annot_epilogue.cuh"
#include "hopper.cuh"
#include "pair_epilogue.cuh"

namespace {

using namespace nldsc;

constexpr int CONSUMERS = 256;           // two consumer warpgroups
constexpr int THREADS = CONSUMERS + 128; // and the producer warpgroup
constexpr int PRODUCER_REGS = 24;
constexpr int CONSUMER_REGS = 240;
enum { FL_USABLE = 1, FL_DOM_OK = 2, FL_POISON = 4 };

// the cluster of a launch: CP pivot tiles x CN neighbour tiles, a CTA
// each, 2 x 2 when CLUSTERED, else 1 x 1 (each CTA loads its own tiles); a
// CTA sends its loads to, and releases its slots to, the PEERS CTAs that
// share its pivot tile or its neighbour tile (itself included)
template <bool CLUSTERED>
struct Clu {
  static constexpr int CP = CLUSTERED ? 2 : 1;
  static constexpr int CN = CLUSTERED ? 2 : 1;
  static constexpr int PEERS = CP + CN - 1;
  static_assert(PEERS <= 4, "one arriving warp of a warpgroup per peer");
};
template <bool MISSING>
struct Cfg;

// rows per TMA box of a launch: Cfg::BOX, halved on the clean branch in
// clusters so that the two CTAs sharing a tile load half of it each
template <bool MISSING, bool CLUSTERED>
__host__ __device__ constexpr int box_rows() {
  return CLUSTERED && !MISSING ? Cfg<MISSING>::BOX / 2 : Cfg<MISSING>::BOX;
}

template <bool MISSING>
struct Cfg {
  static constexpr int TILE = MISSING ? 64 : 128;   // pivot = neighbour rows
  static constexpr int NSIDE = MISSING ? 3 : 2;     // g, h (, m) per side
  static constexpr int STAGES = MISSING ? 4 : 3;
  static constexpr int BOX = MISSING ? 32 : 128;    // rows per TMA box
  static constexpr int WG_COLS = MISSING ? TILE / 2 : TILE;  // per warpgroup
  static constexpr int SIDE_BYTES = NSIDE * TILE * KC;
  static constexpr int STAGE_BYTES = 2 * SIDE_BYTES;
  // partial sums reaching one pivot row: one per warpgroup that splits
  // the neighbour rows; reaching one neighbour row: one per 16-row warp
  static constexpr int ROW_SLOTS = MISSING ? 2 : 1;
  static constexpr int COL_SLOTS = TILE / 16;
};
// staged value tiles: the additive value (row credits, and column credits
// outside the pivot tile, where the two masks agree) and both dominance
// values
enum { V_ADD, V_DA, V_DB, V_TILES };

// annotations a clean launch takes: its row credits stay in registers
// across the two halves of its tile.  With the contractions in its body
// the epilogue's step loop stays rolled, so the clean ANNOT
// instantiations hold the products a1 in a 512-byte stack frame (written
// once after the last product, each step's read back); that leaves the
// registers to 2 x 52 row credits and the pipelined products.  Unrolled,
// a1 stays in registers, but only 64 row credits fit and the epilogue
// runs 1.7 ms longer at p = 53 on the H100 (scripts/time_ld_sym_cuda.py).
constexpr int ANNOT_ROW_MAX = 104;

// Where the annotation epilogue keeps its staged values (V_TILES tiles of
// TILE rows x 64 columns) and the chunk's hi and lo slabs (pivot rows, K =
// TILE; neighbour columns of the staged block, K = 64), as byte offsets
// from the ring, past what the plain epilogue still holds: the partial
// sums (RedSmem, from 0) and, on the clean branch, the stashed Shg
// ([STAGE_BYTES, 2 STAGE_BYTES), 4 KiB per 8 columns: the first 32 KiB are
// consumed by the end of the first half).  AREA: the bytes the ring's
// region must span.
template <bool MISSING>
struct AnnotLayout;
template <>
struct AnnotLayout<false> {
  static constexpr int TILE_B = tc_tile_bytes<128>();
  static constexpr int V_ADD_AT = 131072, V_DA_AT = V_ADD_AT + TILE_B;
  static constexpr int V_DB_AT = 27648;
  static constexpr int ROWS_HI = 65536;
  static constexpr int ROWS_LO = ROWS_HI + tc_slab_bytes<128>();
  static constexpr int COLS_HI = 200704;
  static constexpr int COLS_LO = COLS_HI + tc_slab_bytes<64>();
  static constexpr int AREA = COLS_LO + tc_slab_bytes<64>();
};
template <>
struct AnnotLayout<true> {
  static constexpr int TILE_B = tc_tile_bytes<64>();
  static constexpr int V_ADD_AT = 49152, V_DA_AT = V_ADD_AT + TILE_B;
  static constexpr int V_DB_AT = V_DA_AT + TILE_B;
  static constexpr int ROWS_HI = 102400;
  static constexpr int ROWS_LO = ROWS_HI + tc_slab_bytes<64>();
  static constexpr int COLS_HI = ROWS_LO + tc_slab_bytes<64>();
  static constexpr int COLS_LO = COLS_HI + tc_slab_bytes<64>();
  static constexpr int AREA = COLS_LO + tc_slab_bytes<64>();
};

// bytes from the ring's start to the barriers
template <bool MISSING, bool ANNOT>
__host__ __device__ constexpr int ring_area() {
  constexpr int ring = Cfg<MISSING>::STAGES * Cfg<MISSING>::STAGE_BYTES;
  constexpr int annot = AnnotLayout<MISSING>::AREA;
  return ANNOT && annot > ring ? annot : ring;
}

struct Params {
  CUtensorMap tm_g, tm_h, tm_m;   // boxes of box_rows() rows x KC bytes
  const float* scal;
  const int32_t* lo;
  const int32_t* hi;
  const uint8_t* usable;
  const uint8_t* dom_ok;
  const uint8_t* poison;
  const int32_t* tile_hi;
  float* fpart;
  int32_t* ipart;
  const float* annot;   // ANNOT only: annotation 0 of row 0
  float* apart;
  int p;                // annotations of this launch
  int p_ld;             // floats per row of annot and apart
  int n_piv;            // pivot tiles whose slots are written
  int n_tiles;
  int band;
  int n_pad;
  float n;
  float inv_n;   // f32(1/n): the epilogue's division by n
  float n_padf;
  float adj_c;
  float rsq_thr;
};

// the epilogue's per-row inputs, staged while the ring fills
template <int TILE>
struct EpiSmem {
  float si[TILE][NSCAL];
  float sj[TILE][NSCAL];
  int lo[TILE];
  int hi[TILE];
  unsigned char fi[TILE];
  unsigned char fj[TILE];
};

// the row and column partial sums, written over the ring after the
// last product
template <bool MISSING>
struct RedSmem {
  using C = Cfg<MISSING>;
  float rowf[C::ROW_SLOTS][2][C::TILE];
  int rowi[C::ROW_SLOTS][4][C::TILE];
  float colf[C::COL_SLOTS][2][C::TILE];
  int coli[C::COL_SLOTS][4][C::TILE];
};

// the cluster rank of peer d of the CTA at (pb, pt) (rank pt + CN pb):
// d < CN the CTAs of its pivot tile (itself at d = pt), then those of its
// neighbour tile
template <int CP, int CN>
__device__ __forceinline__ uint32_t peer_rank(int pb, int pt, int d) {
  if (d < CN) return CN * pb + d;
  const int i = d - CN < pb ? d - CN : d - CN + 1;
  return pt + CN * i;
}

template <bool MISSING, bool ANNOT, bool BF16, bool CLUSTERED>
__global__ void __launch_bounds__(THREADS, 1)
    ld_sym_kernel(const __grid_constant__ Params p) {
  using C = Cfg<MISSING>;
  constexpr int CP = Clu<CLUSTERED>::CP, CN = Clu<CLUSTERED>::CN;
  constexpr int PEERS = Clu<CLUSTERED>::PEERS;
  using Acc = std::conditional_t<BF16, float, int>;
  constexpr int T = C::TILE;
  constexpr int KE = stage_samples<BF16>();   // samples per ring stage
  extern __shared__ __align__(16) uint8_t smem_raw[];

  // this CTA's place in its cluster: pivot tile b = b0 + pb, neighbour
  // tile t = b0 + j (t0 + pt); cluster rank pt + CN pb.  Neighbours run
  // fastest, so the CTAs (clusters) that start together share tiles
  const int j = blockIdx.x, b = blockIdx.y;
  const int pb = b % CP, pt = j % CN;
  const int b0 = b - pb;
  const int t = b0 + j, k = t - b;
  // the slot (b, k) this CTA owns, and whether its tiles are in the band
  auto owner = [&](int bb, int kk) {
    return bb < p.n_piv && kk >= 0 && kk < p.band;
  };
  auto live_at = [&](int bb, int tt) {
    return owner(bb, tt - bb) && tt < p.n_tiles && tt <= p.tile_hi[bb];
  };
  const bool live = live_at(b, t);
  if constexpr (ANNOT) {
    if (owner(b, k) && !live) {
      // every annotation slot of a pivot tile is written, zeros here
      const size_t ld = static_cast<size_t>(p.p_ld);
      float* aout = p.apart + (static_cast<size_t>(b) * p.band + k) *
                                  (2 * 2 * C::TILE) * ld;
      for (int i = threadIdx.x; i < 2 * 2 * C::TILE * p.p; i += THREADS)
        aout[(i / p.p) * ld + i % p.p] = 0.f;
    }
  }
  bool cluster_live = false;
#pragma unroll
  for (int i = 0; i < CP; ++i)
#pragma unroll
    for (int q = 0; q < CN; ++q)
      cluster_live |= live_at(b0 + i, b0 + j - pt + q);
  if (!cluster_live) return;   // the whole cluster, at once

  // the ring first, on a swizzle-atom boundary; then the barriers and
  // the epilogue's inputs, at the same offsets in every CTA of the cluster
  uint8_t* ring =
      smem_raw + (ATOM - smem_u32(smem_raw) % ATOM) % ATOM;
  const uint32_t ring_s = smem_u32(ring);
  constexpr int AREA = ring_area<MISSING, ANNOT>();
  const uint32_t full0 = ring_s + AREA;
  const uint32_t empty0 = full0 + 8 * C::STAGES;
  auto& es = *reinterpret_cast<EpiSmem<T>*>(ring + AREA + 16 * C::STAGES);

  const int tid = threadIdx.x;
  const int r0 = b * T, c0 = t * T;
  const int nk = p.n_pad / KE;

  if (tid == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      // in clusters one arrival from each consumer warpgroup of each CTA
      // the slot's loads land in, else one from each consumer thread
      mbar_init(empty0 + 8 * s, CLUSTERED ? 2 * PEERS : CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // every barrier of the cluster initialised before any load or arrival
  if constexpr (CLUSTERED)
    cluster_sync();
  else
    __syncthreads();

  if (tid >= CONSUMERS) {
    // ---- producer warpgroup: one thread loads this CTA's share of every
    // stage: 1 / CN of the pivot tile's boxes, multicast to the CTAs of
    // the pivot tile (ranks CN pb + q), and 1 / CP of the neighbour tile's,
    // multicast to the CTAs of the neighbour tile (ranks pt + CN i); out of
    // clusters, all of both with plain loads
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (tid == CONSUMERS) {
      const uint16_t piv_mask = ((1u << CN) - 1) << (CN * pb);
      uint16_t nbr_mask = 0;
#pragma unroll
      for (int i = 0; i < CP; ++i) nbr_mask |= 1u << (pt + CN * i);
      constexpr int BX = box_rows<MISSING, CLUSTERED>(), BB = BX * KC;
      constexpr int NBOX = T / BX;      // boxes per tile (per side)
      static_assert(NBOX % CP == 0 && NBOX % CN == 0,
                    "a tile's boxes split evenly among the CTAs sharing it");
      constexpr int PQ = NBOX / CN, NQ = NBOX / CP;
      for (int kb = 0; kb < nk; ++kb) {
        const int s = kb % C::STAGES;
        mbar_wait(empty0 + 8 * s, ((kb / C::STAGES) & 1) ^ 1);
        const uint32_t full = full0 + 8 * s;
        // the whole stage lands here: this CTA's share and its peers'
        mbar_expect_tx(full, C::STAGE_BYTES);
        const uint32_t st = ring_s + s * C::STAGE_BYTES;
        const uint32_t nb = st + C::SIDE_BYTES;
        const int x = kb * KE;
        auto load = [&](uint32_t dst, const CUtensorMap* map, int row,
                        uint16_t mask) {
          if constexpr (CLUSTERED)
            tma_load_multicast(dst, map, full, x, row, mask);
          else
            tma_load(dst, map, full, x, row);
        };
        if constexpr (MISSING) {
          // pivot g, h, m of 64 rows, two boxes each; then per consumer
          // warpgroup w its 32 neighbour rows (box w) as [h; g; m]
#pragma unroll
          for (int q = pt * PQ; q < (pt + 1) * PQ; ++q) {
            const int row = r0 + q * BX;
            load(st + q * BB, &p.tm_g, row, piv_mask);
            load(st + T * KC + q * BB, &p.tm_h, row, piv_mask);
            load(st + 2 * T * KC + q * BB, &p.tm_m, row, piv_mask);
          }
#pragma unroll
          for (int w = pb * NQ; w < (pb + 1) * NQ; ++w) {
            const int row = c0 + w * BX;
            load(nb + (3 * w) * BB, &p.tm_h, row, nbr_mask);
            load(nb + (3 * w + 1) * BB, &p.tm_g, row, nbr_mask);
            load(nb + (3 * w + 2) * BB, &p.tm_m, row, nbr_mask);
          }
        } else {
          // pivot g, h; neighbour [g; h]
#pragma unroll
          for (int q = pt * PQ; q < (pt + 1) * PQ; ++q) {
            const int row = r0 + q * BX;
            load(st + q * BB, &p.tm_g, row, piv_mask);
            load(st + T * KC + q * BB, &p.tm_h, row, piv_mask);
          }
#pragma unroll
          for (int q = pb * NQ; q < (pb + 1) * NQ; ++q) {
            const int row = c0 + q * BX;
            load(nb + q * BB, &p.tm_g, row, nbr_mask);
            load(nb + T * KC + q * BB, &p.tm_h, row, nbr_mask);
          }
        }
      }
    }
  } else if (!live) {
    // ---- a CTA outside the band: its consumers only hand each slot back
    // to the CTAs that fill it, once its loads have landed
    const int wi = (tid / 32) % 4, lane = tid & 31;
    for (int kb = 0; kb < nk; ++kb) {
      const int s = kb % C::STAGES;
      mbar_wait(full0 + 8 * s, (kb / C::STAGES) & 1);
      if (lane == 0 && wi < PEERS)
        mbar_arrive_cluster(empty0 + 8 * s, peer_rank<CP, CN>(pb, pt, wi));
    }
  } else {
    // ---- two consumer warpgroups: products, then the epilogue
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    const int wg = tid / 128;
    const int wi = (tid / 32) % 4;       // warp of the warpgroup
    const int lane = tid & 31, gq = lane >> 2, tq = lane & 3;

    for (int c = tid; c < T * NSCAL; c += CONSUMERS) {
      es.si[c / NSCAL][c % NSCAL] = p.scal[static_cast<size_t>(r0) * NSCAL + c];
      es.sj[c / NSCAL][c % NSCAL] = p.scal[static_cast<size_t>(c0) * NSCAL + c];
    }
    for (int r = tid; r < T; r += CONSUMERS) {
      es.lo[r] = p.lo[r0 + r];
      es.hi[r] = p.hi[r0 + r];
      es.fi[r] = (p.usable[r0 + r] ? FL_USABLE : 0) |
                 (p.dom_ok[r0 + r] ? FL_DOM_OK : 0) |
                 (p.poison[r0 + r] ? FL_POISON : 0);
      es.fj[r] = (p.usable[c0 + r] ? FL_USABLE : 0) |
                 (p.dom_ok[c0 + r] ? FL_DOM_OK : 0) |
                 (p.poison[c0 + r] ? FL_POISON : 0);
    }

    // clean: a1 = g_i . [g_j; h_j] (Sgg | Sgh), a2 = h_i . g_j (Shg);
    // missing: a1 = g_i . [h_j; g_j; m_j] (Sgh | Sgg | Sgm),
    // a2 = h_i . [g_j; m_j] (Shg | Shm), a3 = m_i . [h_j; g_j; m_j]
    // (Smh | Smg | Smm); the clean branch leaves a3 unused
    constexpr int N1 = MISSING ? 48 : 128, N2 = MISSING ? 32 : 64;
    constexpr int N3 = MISSING ? 48 : 1;
    // no initial values: each accumulator's first product runs with
    // scale_d = 0 (zeroing them first made ptxas spill the clean branch)
    Acc a1[N1], a2[N2], a3[N3];

    for (int kb = 0; kb < nk; ++kb) {
      const int s = kb % C::STAGES;
      mbar_wait(full0 + 8 * s, (kb / C::STAGES) & 1);
      const uint32_t st = ring_s + s * C::STAGE_BYTES;
      const uint32_t nb = st + C::SIDE_BYTES;
      fence_regs(a1);
      fence_regs(a2);
      fence_regs(a3);
      wgmma_fence();
      if constexpr (MISSING) {
        const uint64_t dg = smem_desc(st), dh = smem_desc(st + T * KC);
        const uint64_t dm = smem_desc(st + 2 * T * KC);
        const uint32_t nw = nb + wg * 3 * C::BOX * KC;
        const uint64_t dhgm = smem_desc(nw);
        const uint64_t dgm = smem_desc(nw + C::BOX * KC);
#pragma unroll
        for (int kk = 0; kk < KC / 32; ++kk) {
          wgmma_n96(a1, dg + 2 * kk, dhgm + 2 * kk, kb + kk > 0);
          wgmma_n64(a2, dh + 2 * kk, dgm + 2 * kk, kb + kk > 0);
          wgmma_n96(a3, dm + 2 * kk, dhgm + 2 * kk, kb + kk > 0);
        }
      } else {
        const uint64_t dg = smem_desc(st + wg * 64 * KC);
        const uint64_t dh = smem_desc(st + T * KC + wg * 64 * KC);
        const uint64_t dgh = smem_desc(nb);
#pragma unroll
        for (int kk = 0; kk < KC / 32; ++kk) {
          wgmma_n256(a1, dg + 2 * kk, dgh + 2 * kk, kb + kk > 0);
          wgmma_n128(a2, dh + 2 * kk, dgh + 2 * kk, kb + kk > 0);
        }
      }
      wgmma_commit();
      // this stage's products are done: hand its slot back to every CTA
      // whose loads land in it (in clusters lane 0 of warp wi to peer wi)
      wgmma_wait_all();
      fence_regs(a1);
      fence_regs(a2);
      fence_regs(a3);
      if constexpr (CLUSTERED) {
        if (lane == 0 && wi < PEERS)
          mbar_arrive_cluster(empty0 + 8 * s, peer_rank<CP, CN>(pb, pt, wi));
      } else {
        mbar_arrive(empty0 + 8 * s);
      }
    }

    // every consumer is past its last product (the ring is free) and
    // the staged inputs are visible
    asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS) : "memory");
    auto& rs = *reinterpret_cast<RedSmem<MISSING>*>(ring);
    // clean: Shg waits in the ring's second stage, each thread's own
    // values in 16-byte words, so that the epilogue starts with 128
    // accumulators live rather than 192
    const uint32_t stash = ring_s + C::STAGE_BYTES + 16 * tid;
    if constexpr (!MISSING) {
#pragma unroll
      for (int q = 0; q < N2 / 4; ++q)
        st_shared4(stash + 16 * CONSUMERS * q, acc_int(a2[4 * q]),
                   acc_int(a2[4 * q + 1]), acc_int(a2[4 * q + 2]),
                   acc_int(a2[4 * q + 3]));
    }

    const bool diag = (t == b);   // mirrored credits only past the pivot tile
    const float n = p.n, inv_n = p.inv_n, adj_c = p.adj_c, rsq = p.rsq_thr;
    const int row0 = MISSING ? 0 : 64 * wg;          // this warpgroup's rows
    const int col0 = MISSING ? C::WG_COLS * wg : 0;  // and neighbour rows
    const int rslot = MISSING ? wg : 0;
    const int cslot = MISSING ? wi : 4 * wg + wi;
    using AL = AnnotLayout<MISSING>;
    auto vt = [&](int v) {
      return reinterpret_cast<float*>(
          ring + (v == V_ADD ? AL::V_ADD_AT
                             : v == V_DA ? AL::V_DA_AT : AL::V_DB_AT));
    };
    const size_t slot = static_cast<size_t>(b) * p.band + k;
    if constexpr (ANNOT) {
      // the pivot tile earns no column credit: its column slots are zeros
      if (diag) {
        const size_t ld = static_cast<size_t>(p.p_ld);
        float* aout = p.apart + (slot * (2 * 2 * T) + 2 * T) * ld;
        for (int i = tid; i < 2 * T * p.p; i += CONSUMERS)
          aout[(i / p.p) * ld + i % p.p] = 0.f;
      }
    }
    // clean: the row credits of up to ANNOT_ROW_MAX annotations, chunk c
    // in racc[.][c], kept across the two halves
    constexpr int NCH = (ANNOT_ROW_MAX + TC_NS - 1) / TC_NS;
    float racc[2][(ANNOT && !MISSING) ? NCH : 1][16];

    int lr[2], rlo[2], rhi[2];
    unsigned rfl[2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      lr[u] = row0 + 16 * wi + gq + 8 * u;
      rlo[u] = es.lo[lr[u]];
      rhi[u] = es.hi[lr[u]];
      rfl[u] = es.fi[lr[u]];
    }
    // counts travel packed in one word, 8 bits each (ws, wsd, wse,
    // poison): at most 128 per row and 16 per column before the sums
    // over warps
    float rl2[2] = {0.f, 0.f}, rl2d[2] = {0.f, 0.f};
    unsigned rcnt[2] = {0u, 0u};

#pragma unroll
    for (int j = 0; j < C::WG_COLS / 8; ++j) {
      float cl2[2] = {0.f, 0.f}, cl2d[2] = {0.f, 0.f};
      unsigned ccnt[2] = {0u, 0u};
      int shg4[4] = {0, 0, 0, 0};
      if constexpr (!MISSING) ld_shared4(stash + 16 * CONSUMERS * j, shg4);
#pragma unroll
      for (int v = 0; v < 2; ++v) {
        const int lc = col0 + 8 * j + 2 * tq + v;
        const float* sj = es.sj[lc];
        const unsigned fj = es.fj[lc];
        const int gj = c0 + lc;
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int e = 4 * j + 2 * u + v;
          const float* si = es.si[lr[u]];
          float sgg, sgh, shg, sgu, sug, suh, suu, shu;
          if constexpr (MISSING) {
            sgh = static_cast<float>(a1[e]);
            sgg = static_cast<float>(a1[16 + e]);
            sgu = si[GSUM] - static_cast<float>(a1[32 + e]);
            shg = static_cast<float>(a2[e]);
            shu = si[HSUM] - static_cast<float>(a2[16 + e]);
            suh = sj[HSUM] - static_cast<float>(a3[e]);
            sug = sj[GSUM] - static_cast<float>(a3[16 + e]);
            suu = p.n_padf - si[CMISS] - sj[CMISS] +
                  static_cast<float>(a3[32 + e]);
          } else {
            sgg = static_cast<float>(a1[e]);
            sgh = static_cast<float>(a1[64 + e]);
            shg = static_cast<float>(shg4[2 * u + v]);
            sgu = si[GSUM];
            sug = sj[GSUM];
            suh = sj[HSUM];
            suu = n;
            shu = si[HSUM];
          }
          const PairAdj pa = pair_adj(sgg, sgh, shg, sgu, sug, suh, suu, shu,
                                      si, sj, inv_n, adj_c);

          const bool upair = gj >= rlo[u] && gj <= rhi[u] &&
                             (rfl[u] & FL_USABLE) && (fj & FL_USABLE);
          const bool row_base = upair && gj != r0 + lr[u];
          const bool col_base = upair && !diag;
          const bool dm_a = row_base && (fj & FL_DOM_OK);
          const bool dm_b = col_base && (rfl[u] & FL_DOM_OK);

          if (row_base) { rl2[u] += pa.add; rcnt[u] += 1u; }
          if (dm_a) {
            rl2d[u] += pa.da;
            rcnt[u] += (1u << 8) + (pa.da > rsq ? 1u << 16 : 0u);
          }
          if (upair && (fj & FL_POISON)) rcnt[u] += 1u << 24;
          if (col_base) {
            cl2[v] += pa.add;
            ccnt[v] += 1u + ((rfl[u] & FL_POISON) ? 1u << 24 : 0u);
          }
          if (dm_b) {
            cl2d[v] += pa.db;
            ccnt[v] += (1u << 8) + (pa.db > rsq ? 1u << 16 : 0u);
          }
          if constexpr (ANNOT) {
            const int sv = lr[u] * TC_LD + lc % 64;
            vt(V_ADD)[sv] = row_base ? pa.add : 0.f;
            vt(V_DA)[sv] = dm_a ? pa.da : 0.f;
            vt(V_DB)[sv] = dm_b ? pa.db : 0.f;
          }
        }
      }
      // columns: over the 8 quads of the warp, then to shared memory
#pragma unroll
      for (int off = 4; off < 32; off <<= 1)
#pragma unroll
        for (int v = 0; v < 2; ++v) {
          cl2[v] += __shfl_xor_sync(0xffffffffu, cl2[v], off);
          cl2d[v] += __shfl_xor_sync(0xffffffffu, cl2d[v], off);
          ccnt[v] += __shfl_xor_sync(0xffffffffu, ccnt[v], off);
        }
      if (gq == 0) {
#pragma unroll
        for (int v = 0; v < 2; ++v) {
          const int lc = col0 + 8 * j + 2 * tq + v;
          rs.colf[cslot][0][lc] = cl2[v];
          rs.colf[cslot][1][lc] = cl2d[v];
#pragma unroll
          for (int q = 0; q < 4; ++q)
            rs.coli[cslot][q][lc] = (ccnt[v] >> (8 * q)) & 255u;
        }
      }
      if constexpr (ANNOT) {
        // a block of 64 neighbour columns is staged (the clean tile's half
        // j / JB, the missing tile whole): contract it.  Outside the pivot
        // tile row_base = col_base, so V_ADD serves both directions;
        // inside it no column credit is earned.
        constexpr int JB = MISSING ? 4 : 8;
        if ((j + 1) % JB == 0) {
          const int h = j / JB;
          const size_t ld = static_cast<size_t>(p.p_ld);
          float* aout = p.apart + slot * (2 * 2 * T) * ld;
          auto pivots = [&](int r) { return p.annot + (r0 + r) * ld; };
          auto neighbours = [&](int c) {
            return p.annot + (c0 + 64 * h + c) * ld;
          };
          consumer_sync();
          if constexpr (MISSING) {
            // both directions once per chunk, each warpgroup one value
            for (int q0 = 0; q0 < p.p; q0 += TC_NS) {
              if (q0 > 0) consumer_sync();
              load_slab<64, false>(ring + AL::COLS_HI, ring + AL::COLS_LO,
                                   neighbours, q0, p.p, tid);
              if (!diag)
                load_slab<T, true>(ring + AL::ROWS_HI, ring + AL::ROWS_LO,
                                   pivots, q0, p.p, tid);
              consumer_sync();
              const int nq = p.p - q0;
              with_width<TC_NS>(min(TC_NS, (nq + 7) & ~7), [&](auto W) {
                constexpr int N = decltype(W)::value;
                float acc[16];
                tc_chunk<N, 64, 1, true>(
                    acc, acc, vt(wg ? V_DA : V_ADD), nullptr,
                    ring_s + AL::COLS_HI, ring_s + AL::COLS_LO, true, wi,
                    lane);
                tc_store<N>(acc, aout + (wg * T) * ld + q0, ld, nq, wi, lane);
                if (!diag) {
                  tc_chunk<N, T, 1, false>(
                      acc, acc, vt(wg ? V_DB : V_ADD), nullptr,
                      ring_s + AL::ROWS_HI, ring_s + AL::ROWS_LO, true, wi,
                      lane);
                  tc_store<N>(acc, aout + ((2 + wg) * T) * ld + q0, ld, nq,
                              wi, lane);
                }
              });
            }
          } else {
            // each warpgroup: the row credits of its 64 rows (both
            // values, into racc) and the column credits of the half's 64
            // columns (one value, written)
            static_for<0, NCH>([&](auto C_) {
              constexpr int c = decltype(C_)::value;
              constexpr int CAP = ANNOT_ROW_MAX - TC_NS * c < TC_NS
                                      ? ANNOT_ROW_MAX - TC_NS * c
                                      : TC_NS;
              const int q0 = TC_NS * c;
              if (q0 < p.p) {
                if (c > 0) consumer_sync();
                load_slab<64, false>(ring + AL::COLS_HI, ring + AL::COLS_LO,
                                     neighbours, q0, p.p, tid);
                if (!diag)
                  load_slab<T, true>(ring + AL::ROWS_HI, ring + AL::ROWS_LO,
                                     pivots, q0, p.p, tid);
                consumer_sync();
                const int nq = p.p - q0;
                with_width<CAP>(min(CAP, (nq + 7) & ~7), [&](auto W) {
                  constexpr int N = decltype(W)::value;
                  tc_chunk<N, 64, 2, true>(
                      racc[0][c], racc[1][c], vt(V_ADD) + 64 * wg * TC_LD,
                      vt(V_DA) + 64 * wg * TC_LD, ring_s + AL::COLS_HI,
                      ring_s + AL::COLS_LO, h == 0, wi, lane);
                  if (!diag) {
                    float acc[16];
                    tc_chunk<N, T, 1, false>(
                        acc, acc, vt(wg ? V_DB : V_ADD), nullptr,
                        ring_s + AL::ROWS_HI, ring_s + AL::ROWS_LO, true, wi,
                        lane);
                    tc_store<N>(acc, aout + ((2 + wg) * T + 64 * h) * ld + q0,
                                ld, nq, wi, lane);
                  }
                  if (h == 1) {
#pragma unroll
                    for (int v = 0; v < 2; ++v)
                      tc_store<N>(racc[v][c],
                                  aout + (v * T + 64 * wg) * ld + q0, ld, nq,
                                  wi, lane);
                  }
                });
              }
            });
          }
          consumer_sync();   // the staged values and slabs are free again
        }
      }
    }
    // rows: over the 4 lanes of a quad, then to shared memory
#pragma unroll
    for (int off = 1; off < 4; off <<= 1)
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        rl2[u] += __shfl_xor_sync(0xffffffffu, rl2[u], off);
        rl2d[u] += __shfl_xor_sync(0xffffffffu, rl2d[u], off);
        rcnt[u] += __shfl_xor_sync(0xffffffffu, rcnt[u], off);
      }
    if (tq == 0) {
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        rs.rowf[rslot][0][lr[u]] = rl2[u];
        rs.rowf[rslot][1][lr[u]] = rl2d[u];
#pragma unroll
        for (int q = 0; q < 4; ++q)
          rs.rowi[rslot][q][lr[u]] = (rcnt[u] >> (8 * q)) & 255u;
      }
    }
    asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS) : "memory");

    // the CTA's partials, summed over warps in a fixed order
    float* fout = p.fpart + slot * (2 * 2 * T);
    int32_t* iout = p.ipart + slot * (2 * 4 * T);
    for (int c = tid; c < 2 * T; c += CONSUMERS) {
      const int dir = c / T, r = c % T;
      float f[2] = {0.f, 0.f};
      int cnt[4] = {0, 0, 0, 0};
      if (dir == 0) {
        for (int w = 0; w < C::ROW_SLOTS; ++w) {
          for (int q = 0; q < 2; ++q) f[q] += rs.rowf[w][q][r];
          for (int q = 0; q < 4; ++q) cnt[q] += rs.rowi[w][q][r];
        }
      } else {
        for (int w = 0; w < C::COL_SLOTS; ++w) {
          for (int q = 0; q < 2; ++q) f[q] += rs.colf[w][q][r];
          for (int q = 0; q < 4; ++q) cnt[q] += rs.coli[w][q][r];
        }
      }
      for (int q = 0; q < 2; ++q) fout[(dir * 2 + q) * T + r] = f[q];
      for (int q = 0; q < 4; ++q) iout[(dir * 4 + q) * T + r] = cnt[q];
    }
  }
  // no CTA leaves while a peer may still load into its ring or arrive on
  // its barriers
  if constexpr (CLUSTERED) cluster_sync();
}

template <bool MISSING, bool ANNOT>
constexpr int smem_bytes() {
  return ATOM + ring_area<MISSING, ANNOT>() + 16 * Cfg<MISSING>::STAGES +
         static_cast<int>(sizeof(EpiSmem<Cfg<MISSING>::TILE>));
}

// a launch of `grid` CTAs in clusters of CP x CN, the kernel's shared
// memory allowed (once per device: a pass with progress launches 16
// times); out of clusters a plain launch (with a cluster dimension of
// 1 x 1 the same kernel ran 10-70% slower on wide rows)
template <bool MISSING, bool ANNOT, bool BF16, bool CLUSTERED>
cudaError_t cluster_config(cudaLaunchConfig_t& cfg, cudaLaunchAttribute& attr,
                           dim3 grid, cudaStream_t stream) {
  constexpr int SMEM = smem_bytes<MISSING, ANNOT>();
  static std::atomic<uint64_t> allowed{0};   // a bit per device below 64
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const uint64_t bit = dev < 64 ? uint64_t{1} << dev : 0;
  if ((allowed.load(std::memory_order_relaxed) & bit) == 0 || bit == 0) {
    err = cudaFuncSetAttribute(ld_sym_kernel<MISSING, ANNOT, BF16, CLUSTERED>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               SMEM);
    if (err != cudaSuccess) return err;
    allowed.fetch_or(bit, std::memory_order_relaxed);
  }
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = Clu<CLUSTERED>::CN;
  attr.val.clusterDim.y = Clu<CLUSTERED>::CP;
  attr.val.clusterDim.z = 1;
  cfg = cudaLaunchConfig_t{};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = SMEM;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = CLUSTERED ? 1 : 0;
  return cudaSuccess;
}

// clusters of the instantiation the current device runs at once (a
// cluster's CTAs share a GPC; out of clusters, CTAs), or minus the CUDA
// error
template <bool MISSING, bool ANNOT, bool BF16, bool CLUSTERED>
int max_clusters() {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = cluster_config<MISSING, ANNOT, BF16, CLUSTERED>(
      cfg, attr, dim3(Clu<CLUSTERED>::CN, Clu<CLUSTERED>::CP), nullptr);
  const void* kernel = reinterpret_cast<const void*>(
      &ld_sym_kernel<MISSING, ANNOT, BF16, CLUSTERED>);
  int n = 0;
  if (err == cudaSuccess && CLUSTERED) {
    err = cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);
  } else if (err == cudaSuccess) {
    int per_sm = 0, dev = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel, THREADS, cfg.dynamicSmemBytes);
    if (err == cudaSuccess) err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    n = per_sm * sms;
  }
  return err == cudaSuccess ? n : -static_cast<int>(err);
}

template <bool MISSING, bool ANNOT, bool BF16, bool CLUSTERED>
cudaError_t launch_in(Params& p, const void* g, const void* m, const void* h,
                      cudaStream_t stream) {
  constexpr int CP = Clu<CLUSTERED>::CP, CN = Clu<CLUSTERED>::CN;
  constexpr int BX = box_rows<MISSING, CLUSTERED>();
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  const int m_pad = p.n_tiles * Cfg<MISSING>::TILE;
  if (!encode<BF16>(fn, &p.tm_g, g, m_pad, p.n_pad, BX) ||
      !encode<BF16>(fn, &p.tm_h, h, m_pad, p.n_pad, BX) ||
      !encode<BF16>(fn, &p.tm_m, m, m_pad, p.n_pad, BX))
    return cudaErrorInvalidValue;
  // neighbour tiles (x) from each pivot group's first up to its last's
  // band end, in groups of CN; pivot tiles (y) in groups of CP, at least
  // one
  const int groups = p.n_piv > 0 ? (p.n_piv + CP - 1) / CP : 1;
  const int nj = (p.band + CP - 1 + CN - 1) / CN;
  if (p.band < 1 || CP * groups > 65535) return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = cluster_config<MISSING, ANNOT, BF16, CLUSTERED>(
      cfg, attr, dim3(CN * nj, CP * groups), stream);
  if (err != cudaSuccess) return err;
  err = cudaLaunchKernelEx(&cfg, ld_sym_kernel<MISSING, ANNOT, BF16, CLUSTERED>,
                           p);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <bool MISSING, bool ANNOT, bool BF16>
cudaError_t launch(Params& p, const void* g, const void* m, const void* h,
                   bool clustered, cudaStream_t stream) {
  using C = Cfg<MISSING>;
  using AL = AnnotLayout<MISSING>;
  constexpr int SMEM = smem_bytes<MISSING, ANNOT>();
  static_assert(sizeof(RedSmem<MISSING>) <= C::STAGE_BYTES,
                "the partial sums must fit in the ring's first stage");
  static_assert(MISSING || (C::STAGES - 1) * C::STAGE_BYTES >=
                                   CONSUMERS * 64 * sizeof(int),
                "the stashed Shg must fit in the ring's later stages");
  // the annotation epilogue's regions: apart from each other, from the
  // partial sums and (clean) from the Shg still stashed; the slabs on
  // swizzle atoms
  constexpr int RED = static_cast<int>(sizeof(RedSmem<MISSING>));
  constexpr int V_END = AL::V_DA_AT + AL::TILE_B;
  static_assert(AL::TILE_B == tc_tile_bytes<C::TILE>(), "staged tiles");
  static_assert(MISSING
                    ? (AL::V_ADD_AT >= RED && AL::V_DB_AT + AL::TILE_B <=
                                                  AL::ROWS_HI)
                    : (AL::V_DB_AT >= RED &&
                       AL::V_DB_AT + AL::TILE_B <= C::STAGE_BYTES &&
                       AL::V_ADD_AT == 2 * C::STAGE_BYTES &&
                       V_END <= AL::COLS_HI &&
                       AL::ROWS_HI == C::STAGE_BYTES &&
                       AL::ROWS_LO + tc_slab_bytes<C::TILE>() <=
                           C::STAGE_BYTES + 8 * 16 * CONSUMERS),
                "annotation epilogue regions overlap");
  static_assert(AL::ROWS_LO - AL::ROWS_HI == tc_slab_bytes<C::TILE>() &&
                    AL::ROWS_HI % ATOM == 0 && AL::ROWS_LO % ATOM == 0 &&
                    AL::COLS_HI % ATOM == 0 && AL::COLS_LO % ATOM == 0 &&
                    (!MISSING || AL::COLS_HI >= AL::ROWS_LO +
                                                    tc_slab_bytes<C::TILE>()),
                "annotation slabs on swizzle atoms, apart");
  static_assert(SMEM <= 232448, "shared memory of one CTA");
  return clustered
             ? launch_in<MISSING, ANNOT, BF16, true>(p, g, m, h, stream)
             : launch_in<MISSING, ANNOT, BF16, false>(p, g, m, h, stream);
}

template <bool BF16>
cudaError_t launch_branch(Params& p, const void* g, const void* m,
                          const void* h, int has_missing, bool annot,
                          bool clustered, cudaStream_t s) {
  if (annot)
    return has_missing ? launch<true, true, BF16>(p, g, m, h, clustered, s)
                       : launch<false, true, BF16>(p, g, m, h, clustered, s);
  return has_missing ? launch<true, false, BF16>(p, g, m, h, clustered, s)
                     : launch<false, false, BF16>(p, g, m, h, clustered, s);
}

template <bool CLUSTERED>
int max_clusters_of(int has_missing, int annot, int bf16) {
  if (bf16 != 0) {
    if (annot != 0)
      return has_missing ? max_clusters<true, true, true, CLUSTERED>()
                         : max_clusters<false, true, true, CLUSTERED>();
    return has_missing ? max_clusters<true, false, true, CLUSTERED>()
                       : max_clusters<false, false, true, CLUSTERED>();
  }
  if (annot != 0)
    return has_missing ? max_clusters<true, true, false, CLUSTERED>()
                       : max_clusters<false, true, false, CLUSTERED>();
  return has_missing ? max_clusters<true, false, false, CLUSTERED>()
                     : max_clusters<false, false, false, CLUSTERED>();
}

}  // namespace

// annotations one launch takes on each branch
extern "C" int ld_sym_annot_max(int has_missing) {
  return has_missing ? (1 << 30) : ANNOT_ROW_MAX;
}

// rows of a CTA's pivot (and neighbour) tile on each branch
extern "C" int ld_sym_tile(int has_missing) {
  return has_missing ? Cfg<true>::TILE : Cfg<false>::TILE;
}

// the pivot tiles (pivots != 0) or neighbour tiles of a clustered
// launch's cluster
extern "C" int ld_sym_cluster(int pivots) {
  return pivots ? Clu<true>::CP : Clu<true>::CN;
}

// cudaOccupancyMaxActiveClusters of an instantiation on the current
// device (clusters of one CTA when not clustered), or minus the CUDA error
extern "C" int ld_sym_max_clusters(int has_missing, int annot, int bf16,
                                   int clustered) {
  return clustered != 0 ? max_clusters_of<true>(has_missing, annot, bf16)
                        : max_clusters_of<false>(has_missing, annot, bf16);
}

extern "C" int ld_sym_launch(const void* g, const void* m, const void* h,
                             const void* scal, const void* lo, const void* hi,
                             const void* usable, const void* dom_ok,
                             const void* poison, const void* tile_hi,
                             void* fpart, void* ipart, const void* annot,
                             void* apart, int n_annot, int annot_ld,
                             int n_piv, int n_tiles, int band,
                             int n_pad, float n, float inv_n, float n_padf,
                             float adj_c, float rsq_thr, int has_missing,
                             int bf16, int clustered, void* stream) {
  Params p;
  p.scal = static_cast<const float*>(scal);
  p.lo = static_cast<const int32_t*>(lo);
  p.hi = static_cast<const int32_t*>(hi);
  p.usable = static_cast<const uint8_t*>(usable);
  p.dom_ok = static_cast<const uint8_t*>(dom_ok);
  p.poison = static_cast<const uint8_t*>(poison);
  p.tile_hi = static_cast<const int32_t*>(tile_hi);
  p.fpart = static_cast<float*>(fpart);
  p.ipart = static_cast<int32_t*>(ipart);
  p.annot = static_cast<const float*>(annot);
  p.apart = static_cast<float*>(apart);
  p.p = n_annot;
  p.p_ld = annot_ld;
  p.n_piv = n_piv;
  p.n_tiles = n_tiles;
  p.band = band;
  p.n_pad = n_pad;
  p.n = n;
  p.inv_n = inv_n;
  p.n_padf = n_padf;
  p.adj_c = adj_c;
  p.rsq_thr = rsq_thr;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const void* mm = has_missing ? m : g;   // clean: never read
  // annot (with apart and 1 <= n_annot <= annot_ld; on the clean branch
  // n_annot <= ANNOT_ROW_MAX) selects the annotation epilogue, bf16 the
  // instantiations on bf16 operands, clustered the launch in clusters of
  // CP x CN; n_piv <= n_tiles pivot tiles write their slots
  if (n_piv < 0 || n_piv > n_tiles ||
      (annot != nullptr &&
       (n_annot < 1 || n_annot > annot_ld ||
        (!has_missing && n_annot > ANNOT_ROW_MAX))))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  if (bf16 != 0)
    err = launch_branch<true>(p, g, mm, h, has_missing, annot != nullptr,
                              clustered != 0, s);
  else
    err = launch_branch<false>(p, g, mm, h, has_missing, annot != nullptr,
                               clustered != 0, s);
  return static_cast<int>(err);
}
