// Split-missing corrections for Hopper (sm_90a): kernel K2, with the delta
// epilogue fused in.
//
// K2, split_corr_kernel, replaces scripts/pallas_corr_probe.py::kernel
// (launcher corr_pallas), the read-fusing form of the two big launches of
// nldsc_tpu/ld/ld_split.py::split_corrections, and the per-pair epilogue
// that follows them there.  For one segment of x rows (a slice of g) and
// the compact rows in reach of its windows, cat3 = [g_c; m_c; h_c] (P rows
// each), the products are exact int32
//     a = g_x . cat3^T          Sgg | Sgm | Sgh     (x rows, 3P)
//     b = h(g_x) . cat3[:2P]^T  Shg | Shm           (x rows, 2P)
// with h(x) = 2 min(x, 1) derived in registers from the landed g stage, so
// h of the x rows is never read from device memory.  The grid covers
// (compact-column tiles, x-row tiles, segments) in one launch; a table of
// per-segment fields (first x row, first compact row, compact count,
// first owned row) gives each CTA its coordinates, so cat3 is never
// built: the three blocks are TMA boxes from three tensor maps, over g_c,
// m_c and h_c, at the segment's compact row.  Ragged edges are zero-filled
// by TMA's out-of-bounds fill or masked in the epilogue.
//
// Two modes, one kernel:
//   * fused (the split route): after the last stage, the consumer threads
//     turn their accumulators into delta = adj(exact) - adj(clean) for every
//     counted pair through pair_epilogue.cuh's pair_adj -- the function
//     K1's clean pass uses, built with -fmad=false, so the clean value
//     cancels that pass's bit for bit.  The orientation is chosen first
//     (pass 1 evaluated each pair with its left member as i), so pair_adj
//     runs twice per pair: exact and clean.  A tile whose compact columns
//     lie outside the windows of all its x rows skips its products, as K1
//     skips the tiles outside its band.  Each CTA writes row partials
//     (credits to x) at the x rows its segment owns and column partials
//     (credits to the compact rows), folded outside in a fixed order: no
//     float atomics.  a and b never reach device memory; the products of
//     the contaminated x rows' missing indicators, d = m_xc . cat3^T, come
//     from one products-mode launch over all segments before it.
//   * products: a (and b, when the wrapper asks for it) written to device
//     memory.  It computes d, and serves ld_split.corr_products.
// The fused mode's ANNOT instantiation adds the annotation delta credits
// of nldsc_tpu/ld/ld_split.py::split_corrections (annot branch).  The pass
// that computes a live tile's deltas stages its four masked values in the
// freed ring, every slot once (zeros where no pair is counted): the
// credits to x as floats, the mirrored credits to the compact columns
// split into tf32 hi and lo and swizzled as a wgmma B operand.  Then
// annot_epilogue.cuh's tc_chunk contracts them on the tensor cores with
// the annotations of the compact columns (credits to x) and of the x rows
// (mirrored credits; the annotations as M, since the tile has 32 columns).
// Each live tile writes one slot of row and column partials, numbered by
// the wrapper (tile_slot), which folds them in a fixed order.  The plain
// sums of an ANNOT launch are those of a plain launch bit for bit.
//
// bf16 operands (the BF16 instantiations, under --dot-dtype bf16, as the
// probe casts each K chunk to bf16, scripts/pallas_corr_probe.py:55-73):
// the same products on wgmma.m64nNk16.f32.bf16.bf16, 64 samples a stage in
// the same bytes of ring, h derived from two packed bf16 codes (h_of_bf16),
// f32 accumulators that hold the int8 sums exactly (integers below 2^24);
// the products mode stores them as int32 (acc_int), so d and the fused
// epilogue are those of the int8 instantiations.
//
// What bounds it on this card: int8 tensor-core operations fed from L2.
// Each stage of KC bytes brings TM x rows and 3 TC compact rows for
// TM x 5 TC products: 183 int8 operations per byte of L2 traffic at
// TM = 128, TC = 32.  The products run on wgmma.m64nNk32.s32.s8.s8: A = g_x
// from shared memory against the whole stack (n96), A = h(g_x) from
// registers against [g_c; m_c] (n64); the thread that holds Sgg(r, c)
// holds Sgm, Sgh, Shg and Shm at (r, c) too.  One producer thread keeps a
// ring of STAGES stages full by TMA, through mbarriers; two consumer
// warpgroups (64 x rows each) issue the products, raised to 240 registers
// by setmaxnreg.  The grid runs the compact-column tiles fastest, so the
// CTAs that share an x tile run together and read it from L2 after the
// first.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "annot_epilogue.cuh"
#include "hopper.cuh"
#include "pair_epilogue.cuh"

namespace {

using namespace nldsc;

constexpr int TM = 128;                  // x rows per CTA
constexpr int TC = 32;                   // compact columns per CTA (per block)
constexpr int NB = 3 * TC;               // stacked rows [g_c; m_c; h_c]
constexpr int STAGES = 6;
constexpr int A_BYTES = TM * KC;
constexpr int STAGE_BYTES = A_BYTES + NB * KC;
constexpr int CONSUMERS = 256;           // two consumer warpgroups
constexpr int THREADS = CONSUMERS + 128; // and the producer warpgroup
constexpr int PRODUCER_REGS = 24;
constexpr int CONSUMER_REGS = 240;
constexpr int SEG_FIELDS = 4;            // first x row, c0, c_cnt, seg_lo
enum { FL_OWNED = 1, FL_USABLE = 2, FL_DOM_OK = 4, FL_ROWMISS = 8 };
// The annotation epilogue contracts QS annotations a pass: two row
// chunks of TC_NS, one column chunk.  Its regions in the ring the products
// have freed, as byte offsets: the staged credits to x (additive,
// dominance: TM x TC floats each, XLD words a row); the staged mirrored
// credits to the compact columns (additive, dominance: a hi and a lo slab
// each, K = the TM x rows, N = the TC columns); the two row chunks' hi and
// lo slabs of the compact columns' annotations (B of the rows, K = TC);
// the pass's annotations of the x rows (A of the columns, TM x QS, TC_LD
// words a row).  Once the pass has read the last two, its credits to x are
// staged from ROWS_B on (2 values x TM rows x QS, OLD words a row) for
// stores of whole lines.
constexpr int XLD = TC + 4;
constexpr int QS = 2 * TC_NS;
// floats per row of the annotation partials: p rounded up to 8
__host__ __device__ constexpr int annot_ld(int p) { return (p + 7) & ~7; }
struct AnnotLayout {
  static constexpr int X_VALS = 0;
  static constexpr int C_SLAB = tc_slab_bytes<TM>();
  static constexpr int C_SLABS = 2 * TM * XLD * 4;   // V_CADD hi, lo; V_CDOM
  static constexpr int R_SLAB = tc_slab_bytes<TC>();
  static constexpr int ROWS_B = C_SLABS + 4 * C_SLAB;   // chunk h: hi, lo
  static constexpr int COLS_A = ROWS_B + 4 * R_SLAB;
  static constexpr int END = COLS_A + tc_tile_bytes<TM>();
  static constexpr int OLD = TC_LD;
  static constexpr int OUT_END = ROWS_B + 2 * TM * OLD * 4;
};

struct Params {
  CUtensorMap tm_a;        // the x rows, boxes of TM rows
  CUtensorMap tm_b[3];     // the three stacked blocks, boxes of TC rows
  const int32_t* seg;      // [n_segs][SEG_FIELDS], or null (all zero)
  int boff[3];             // row offset of each block within its map
  int rows_a;              // x rows of a segment
  int P;                   // compact columns of a segment, per block
  int n_pad;
  // products mode: column q P + c of a row holds block q's column c
  int32_t* out_a;          // [n_segs][rows_a][ld_a]
  int32_t* out_b;          // [n_segs][rows_a][ld_b]
  int ld_a, ld_b;
  // fused mode
  const int32_t* d;        // [n_segs][p_x][3P]: smg | smm | smh
  const int32_t* drow;     // [n_segs][rows_a]: row of d of each x, or -1
  const float* scal;       // (m_pad, NSCAL)
  const int32_t* lo;
  const int32_t* hi;
  const uint8_t* usable;
  const uint8_t* dom_ok;
  const uint8_t* rowmiss;
  const float* scal_c;     // (mm_pad, NSCAL), compact order
  const int32_t* cidx;     // (mm_pad,) global row of each compact row
  const uint8_t* usable_c;
  const uint8_t* dom_ok_c;
  float* rpart_f;          // [n_ct][2 (l2, l2d)][m_pad]
  int32_t* rpart_i;        // [n_ct][m_pad] (wse)
  float* cpart_f;          // [n_segs][n_xt][2][P]
  int32_t* cpart_i;        // [n_segs][n_xt][P]
  // fused mode with annotations: the live tile (sg, xt, ct) writes slot
  // tile_slot[sg][xt][ct] of the partials, annotations [0, p) of each
  // row; pld = p rounded up to 8 (annot_ld), so that rows start on
  // 32-byte sectors
  const float* annot;      // (m_pad, p)
  const float* annot_c;    // (mm_pad, p), compact order
  float* rpart_a;          // [n_live][2][TM][pld]
  float* cpart_a;          // [n_live][TC][2][pld]
  int p;
  int p_x, m_pad, own_hi;
  float n, inv_n, n_padf, pad_const, adj_c, rsq;   // inv_n = f32(1/n)
  const int32_t* tile_slot;   // [n_segs][n_xt][n_ct]: slot, or -1
};

// the fused epilogue's per-row and per-column inputs, staged while the
// ring fills, and the column sums of the 8 consumer warps
struct EpiSmem {
  float sx[TM][NSCAL];
  float sc[TC][NSCAL];
  int lo[TM];
  int hi[TM];
  int drow[TM];
  int cidx[TC];
  unsigned char fx[TM];
  unsigned char fc[TC];
  float colf[8][2][TC];
  int coli[8][TC];
};

// h = 2 min(x, 1) on four packed codes in {0, 1, 2}: a byte is nonzero
// iff its bit 0 or bit 1 is set
__device__ __forceinline__ uint32_t h_of(uint32_t v) {
  return ((v | (v >> 1)) & 0x01010101u) << 1;
}
// the same on two packed bf16 codes in {0, 1.0, 2.0}: a half is nonzero
// iff adding 0x7FFF to it (no carry out of the half) sets its top bit, and
// then h = 2.0 = 0x4000
__device__ __forceinline__ uint32_t h_of_bf16(uint32_t v) {
  return (((v & 0x7FFF7FFFu) + 0x7FFF7FFFu) & 0x80008000u) >> 1;
}

__device__ __forceinline__ uint32_t ld_shared_u32(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.u32 %0, [%1];\n" : "=r"(v) : "r"(addr) : "memory");
  return v;
}

// fused mode: a tile counts no pair unless one of the x rows it owns has
// a window that reaches one of its real compact columns.  Those are
// sorted, so the first and the last bound them.  Row tid of the tile
// (x0, cl0) of the segment with these fields (its first x row a_row0 and
// compact row c0): does it reach?
__device__ __forceinline__ int reaches(const int32_t* fields, int a_row0,
                                       int c0, const int32_t* lo,
                                       const int32_t* hi, const int32_t* cidx,
                                       int rows_a, int x0, int cl0, int tid) {
  const int c_end = min(cl0 + TC, fields[2]);
  const int xl = x0 + tid, gx = a_row0 + xl;
  return tid < TM && cl0 < c_end && xl < rows_a && gx >= fields[3] &&
         lo[gx] <= cidx[c0 + c_end - 1] && hi[gx] >= cidx[c0 + cl0];
}

template <bool FUSED, bool WITH_H, bool ANNOT, bool BF16>
__global__ void __launch_bounds__(THREADS, 1)
    split_corr_kernel(const __grid_constant__ Params p) {
  using Acc = std::conditional_t<BF16, float, int>;
  constexpr int KE = stage_samples<BF16>();   // samples per ring stage
  static_assert(!FUSED || WITH_H, "the fused epilogue needs Shg and Shm");
  static_assert(FUSED || !ANNOT, "annotations belong to the fused epilogue");
  extern __shared__ __align__(16) uint8_t smem_raw[];

  // the ring first, on a swizzle-atom boundary; then the barriers and
  // the epilogue's inputs
  uint8_t* ring = smem_raw + (ATOM - smem_u32(smem_raw) % ATOM) % ATOM;
  const uint32_t ring_s = smem_u32(ring);
  const uint32_t full0 = ring_s + STAGES * STAGE_BYTES;
  const uint32_t empty0 = full0 + 8 * STAGES;
  auto& es = *reinterpret_cast<EpiSmem*>(ring + STAGES * STAGE_BYTES +
                                         16 * STAGES);

  const int ct = blockIdx.x, xt = blockIdx.y, sg = blockIdx.z;
  const int tid = threadIdx.x;
  const int32_t* fields = p.seg ? p.seg + sg * SEG_FIELDS : nullptr;
  const int a_row0 = fields ? fields[0] : 0;   // the segment's first x row
  const int c0 = fields ? fields[1] : 0;       // and first compact row
  const int x0 = xt * TM;                      // the tile's, in the segment
  const int cl0 = ct * TC;
  const int nk = p.n_pad / KE;

  // fused mode: a tile that no window reaches (reaches()) skips its
  // products and writes zero partials
  int reach = 1;
  if constexpr (FUSED)
    reach = reaches(fields, a_row0, c0, p.lo, p.hi, p.cidx, p.rows_a, x0,
                    cl0, tid);

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  const bool live = __syncthreads_or(reach) != 0;

  if (tid >= CONSUMERS) {
    // ---- producer warpgroup: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (tid == CONSUMERS && live) {
      for (int kb = 0; kb < nk; ++kb) {
        const int s = kb % STAGES;
        mbar_wait(empty0 + 8 * s, ((kb / STAGES) & 1) ^ 1);
        const uint32_t full = full0 + 8 * s;
        mbar_expect_tx(full, STAGE_BYTES);
        const uint32_t st = ring_s + s * STAGE_BYTES;
        const int x = kb * KE;
        tma_load(st, &p.tm_a, full, x, a_row0 + x0);
#pragma unroll
        for (int q = 0; q < 3; ++q)
          tma_load(st + A_BYTES + q * TC * KC, &p.tm_b[q], full, x,
                   c0 + p.boff[q] + cl0);
      }
    }
    return;
  }

  // ---- two consumer warpgroups: products, then the epilogue
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
  const int wg = tid / 128;
  const int wi = (tid / 32) % 4;         // warp of the warpgroup
  const int lane = tid & 31, gq = lane >> 2, tq = lane & 3;
  const int row0 = 64 * wg + 16 * wi + gq;   // this thread's rows: +0, +8
  // the annotation epilogue's slot: a live tile's, CTA-uniform
  const int slot =
      ANNOT ? p.tile_slot[(static_cast<size_t>(sg) * gridDim.y + xt) *
                              gridDim.x + ct]
            : -1;

  if constexpr (FUSED) {
    const int c_cnt = fields[2], seg_lo = fields[3];
    for (int i = tid; i < TM * NSCAL; i += CONSUMERS) {
      const int xl = x0 + i / NSCAL;
      es.sx[i / NSCAL][i % NSCAL] =
          xl < p.rows_a
              ? p.scal[static_cast<size_t>(a_row0 + xl) * NSCAL + i % NSCAL]
              : 0.f;
    }
    for (int r = tid; r < TM; r += CONSUMERS) {
      const int xl = x0 + r, gx = a_row0 + xl;
      const bool in = xl < p.rows_a;
      es.lo[r] = in ? p.lo[gx] : 0;
      es.hi[r] = in ? p.hi[gx] : -1;
      es.drow[r] = in ? p.drow[static_cast<size_t>(sg) * p.rows_a + xl] : -1;
      es.fx[r] = (in && gx >= seg_lo)
                     ? FL_OWNED | (p.usable[gx] ? FL_USABLE : 0) |
                           (p.dom_ok[gx] ? FL_DOM_OK : 0) |
                           (p.rowmiss[gx] ? FL_ROWMISS : 0)
                     : 0;
    }
    for (int i = tid; i < TC * NSCAL; i += CONSUMERS) {
      const int cc = cl0 + i / NSCAL;
      es.sc[i / NSCAL][i % NSCAL] =
          cc < p.P
              ? p.scal_c[static_cast<size_t>(c0 + cc) * NSCAL + i % NSCAL]
              : 0.f;
    }
    for (int c = tid; c < TC; c += CONSUMERS) {
      const int cc = cl0 + c;
      const bool in = cc < p.P;
      es.cidx[c] = in ? p.cidx[c0 + cc] : -1;
      // a compact column counts when it is one of the segment's c_cnt
      // real rows and usable (FL_OWNED marks that here)
      es.fc[c] = (in && cc < c_cnt && p.usable_c[c0 + cc])
                     ? FL_OWNED | (p.dom_ok_c[c0 + cc] ? FL_DOM_OK : 0)
                     : 0;
    }
  }

  // a1 = g_x . [g_c; m_c; h_c] (Sgg | Sgm | Sgh), a2 = h(g_x) . [g_c; m_c]
  // (Shg | Shm).  No initial values: each accumulator's first product
  // runs with scale_d = 0.
  Acc a1[48];
  Acc a2[WITH_H ? 32 : 1];
  // this thread's two rows of the landed g tile (bytes: a bf16 stage holds
  // the same bytes of each row as an int8 one): byte k of row r lies at
  // r * KC + ((k / 16) ^ (r % 8)) * 16 + k % 16 in the 128-byte swizzle,
  // and r % 8 = gq
  const uint32_t arow = static_cast<uint32_t>(row0) * KC + 4 * tq;

  for (int kb = 0; live && kb < nk; ++kb) {
    const int s = kb % STAGES;
    mbar_wait(full0 + 8 * s, (kb / STAGES) & 1);
    const uint32_t st = ring_s + s * STAGE_BYTES;
    uint32_t hf[4][WITH_H ? 4 : 1];
    if constexpr (WITH_H) {
#pragma unroll
      for (int kk = 0; kk < KC / 32; ++kk)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const uint32_t at = st + arow + (((2 * kk + half) ^ gq) << 4);
          const uint32_t v0 = ld_shared_u32(at);
          const uint32_t v1 = ld_shared_u32(at + 8 * KC);
          hf[kk][2 * half] = BF16 ? h_of_bf16(v0) : h_of(v0);
          hf[kk][2 * half + 1] = BF16 ? h_of_bf16(v1) : h_of(v1);
        }
      // h complete before the products read it
#pragma unroll
      for (int kk = 0; kk < KC / 32; ++kk) fence_regs(hf[kk]);
    }
    fence_regs(a1);
    fence_regs(a2);
    wgmma_fence();
    const uint64_t da = smem_desc(st + wg * 64 * KC);
    const uint64_t db = smem_desc(st + A_BYTES);
#pragma unroll
    for (int kk = 0; kk < KC / 32; ++kk) {
      wgmma_n96(a1, da + 2 * kk, db + 2 * kk, kb + kk > 0);
      if constexpr (WITH_H)
        wgmma_n64_rs(a2, hf[kk], db + 2 * kk, kb + kk > 0);
    }
    wgmma_commit();
    // this stage's products are done: hand its slot back
    wgmma_wait_all();
    fence_regs(a1);
    fence_regs(a2);
    if constexpr (WITH_H) {
#pragma unroll
      for (int kk = 0; kk < KC / 32; ++kk) fence_regs(hf[kk]);
    }
    mbar_arrive(empty0 + 8 * s);
  }

  if constexpr (!FUSED) {
    // ---- products mode: block q's column c goes to column q P + c
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int xl = x0 + row0 + 8 * u;
      if (xl >= p.rows_a) continue;
      const size_t r = static_cast<size_t>(sg) * p.rows_a + xl;
#pragma unroll
      for (int j = 0; j < NB / 8; ++j)
#pragma unroll
        for (int v = 0; v < 2; ++v) {
          const int c = cl0 + 8 * (j % 4) + 2 * tq + v;
          const int col = (j / 4) * p.P + c;
          if (c < p.P && col < p.ld_a)
            p.out_a[r * p.ld_a + col] = acc_int(a1[4 * j + 2 * u + v]);
        }
      if constexpr (WITH_H) {
#pragma unroll
        for (int j = 0; j < 2 * TC / 8; ++j)
#pragma unroll
          for (int v = 0; v < 2; ++v) {
            const int c = cl0 + 8 * (j % 4) + 2 * tq + v;
            const int col = (j / 4) * p.P + c;
            if (c < p.P && col < p.ld_b)
              p.out_b[r * p.ld_b + col] = acc_int(a2[4 * j + 2 * u + v]);
          }
      }
    }
    return;
  } else {
    // ---- fused mode: the delta epilogue on the accumulators
    // every consumer is past its last product and the staged inputs are
    // visible
    asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS) : "memory");
    const int P = p.P;
    const float n = p.n, inv_n = p.inv_n, n_padf = p.n_padf,
                adj_c = p.adj_c, rsq = p.rsq;
    const int gx0 = a_row0 + x0;
    int gx[2], rlo[2], rhi[2], dr[2];
    unsigned fx[2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int lr = row0 + 8 * u;
      gx[u] = gx0 + lr;
      rlo[u] = es.lo[lr];
      rhi[u] = es.hi[lr];
      dr[u] = es.drow[lr];
      fx[u] = es.fx[lr];
    }
    float rl2[2] = {0.f, 0.f}, rl2d[2] = {0.f, 0.f};
    int rwse[2] = {0, 0};
    const int warp8 = 4 * wg + wi;
    using AL = AnnotLayout;
    // a pass's annotations: of the x rows as floats (thread t: annotation
    // q0 + t % QS of rows t / QS + RS k), of the compact columns split into
    // the row chunks' slabs (annotation q0 + TC_NS h + t % TC_NS of columns
    // t / TC_NS + CS k); zeros past their ends, loaded only where they
    // are not
    const int np = ANNOT ? p.p : 0, pld = annot_ld(np);
    auto fetch = [&](int q0) {
      constexpr int RS = CONSUMERS / QS, CS = CONSUMERS / TC_NS;
      {
        const int r0 = tid / QS, q = q0 + tid % QS;
        const int rows = q < np ? p.rows_a - x0 - r0 : 0;
        const float* src = p.annot + static_cast<size_t>(gx0 + r0) * np + q;
        const size_t step = static_cast<size_t>(RS) * np;
        float* at = reinterpret_cast<float*>(ring + AL::COLS_A) +
                    r0 * TC_LD + tid % QS;
#pragma unroll 16
        for (int k = 0; k < TM / RS; ++k)
          at[k * RS * TC_LD] = RS * k < rows ? src[k * step] : 0.f;
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int n = tid % TC_NS, q = q0 + TC_NS * h + n;
        const int cols = q < np ? P - cl0 - tid / TC_NS : 0;
        const float* src =
            p.annot_c + static_cast<size_t>(c0 + cl0 + tid / TC_NS) * np + q;
        const size_t step = static_cast<size_t>(CS) * np;
#pragma unroll
        for (int k = 0; k < TC / CS; ++k) {
          uint32_t hi, lo;
          split_tf32(CS * k < cols ? src[k * step] : 0.f, hi, lo);
          uint8_t* b = ring + AL::ROWS_B + 2 * h * AL::R_SLAB +
                       slab_offset<false>(tid / TC_NS + CS * k, n);
          *reinterpret_cast<uint32_t*>(b) = hi;
          *reinterpret_cast<uint32_t*>(b + AL::R_SLAB) = lo;
        }
      }
      fence_proxy_async();   // the slabs, for wgmma
    };
    // the tile's annotation rows (x rows and compact columns, each block
    // contiguous) into L2 while the deltas are computed
    if constexpr (ANNOT) {
      if (slot >= 0) {
        const int xr = min(TM, p.rows_a - x0), cr = min(TC, P - cl0);
        const char* xs = reinterpret_cast<const char*>(
            p.annot + static_cast<size_t>(gx0) * np);
        const char* cs = reinterpret_cast<const char*>(
            p.annot_c + static_cast<size_t>(c0 + cl0) * np);
        const int xl_n = (xr * np * 4 + 127) / 128;
        const int cl_n = (cr * np * 4 + 127) / 128;
        for (int i = tid; i < xl_n + cl_n; i += CONSUMERS)
          prefetch_l2(i < xl_n ? xs + 128 * i : cs + 128 * (i - xl_n));
      }
    }
    // the pass's four values of pair (row0 + 8 u, 8 j + 2 tq + v) staged
    // for the annotation epilogue; a slab column's swizzle depends on the
    // column mod 8 alone, so each (u, v) has one offset, plus j atoms
    int soff[2][2];
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int v = 0; v < 2; ++v)
        soff[u][v] = slab_offset<true>(row0 + 8 * u, 2 * tq + v);
    auto stage = [&](int u, int j, int v, float xadd, float xdom, float cadd,
                     float cdom) {
      float* xv = reinterpret_cast<float*>(ring + AL::X_VALS) +
                  (row0 + 8 * u) * XLD + 8 * j + 2 * tq + v;
      xv[0] = xadd;
      xv[TM * XLD] = xdom;
      uint8_t* cs = ring + AL::C_SLABS + soff[u][v] + j * ATOM;
      const float cv[2] = {cadd, cdom};
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        uint32_t h, l;
        split_tf32(cv[q], h, l);
        *reinterpret_cast<uint32_t*>(cs + 2 * q * AL::C_SLAB) = h;
        *reinterpret_cast<uint32_t*>(cs + (2 * q + 1) * AL::C_SLAB) = l;
      }
    };

#pragma unroll
    for (int j = 0; j < TC / 8; ++j)
#pragma unroll
      for (int v = 0; v < 2; ++v) {
        const int lc = 8 * j + 2 * tq + v;
        const int c = cl0 + lc;
        const float* sc = es.sc[lc];
        const int gc = es.cidx[lc];
        const unsigned fc = es.fc[lc];
        float cl2 = 0.f, cl2d = 0.f;
        int cwse = 0;
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const bool pair = (fc & FL_OWNED) && (fx[u] & FL_OWNED) &&
                            (fx[u] & FL_USABLE) && gc != gx[u] &&
                            gc >= rlo[u] && gc <= rhi[u] &&
                            min(gx[u], gc) < p.own_hi;
          if (!pair) {
            if constexpr (ANNOT)
              if (slot >= 0) stage(u, j, v, 0.f, 0.f, 0.f, 0.f);
            continue;
          }
          const int e = 4 * j + 2 * u + v;
          const float sgg = static_cast<float>(a1[e]);
          const float sgm = static_cast<float>(a1[16 + e]);
          const float sgh = static_cast<float>(a1[32 + e]);
          const float shg = static_cast<float>(a2[e]);
          const float shm = static_cast<float>(a2[16 + e]);
          float smg = 0.f, smm_d = 0.f, smh = 0.f;
          if (dr[u] >= 0) {
            const size_t rd =
                (static_cast<size_t>(sg) * p.p_x + dr[u]) * 3 * P;
            smg = static_cast<float>(p.d[rd + c]);
            smm_d = static_cast<float>(p.d[rd + P + c]);
            smh = static_cast<float>(p.d[rd + 2 * P + c]);
          }
          const bool cln = !(fx[u] & FL_ROWMISS);
          const float smm = cln ? p.pad_const : smm_d;
          // pass 1 evaluated the pair with its left member as i: the
          // role-swapped dots when the compact row comes first
          const bool swap = gc < gx[u];
          const float* sx = es.sx[row0 + 8 * u];
          const float* si = swap ? sc : sx;
          const float* sj = swap ? sx : sc;
          const float s_gh = swap ? shg : sgh, s_hg = swap ? sgh : shg;
          const float m_i = swap ? smg : sgm, m_j = swap ? sgm : smg;
          const float h_j = swap ? shm : smh, h_i = swap ? smh : shm;
          const PairAdj ex = pair_adj(
              sgg, s_gh, s_hg, si[GSUM] - m_i, sj[GSUM] - m_j,
              sj[HSUM] - h_j, n_padf - si[CMISS] - sj[CMISS] + smm,
              si[HSUM] - h_i, si, sj, inv_n, adj_c);
          const PairAdj e0 = pair_adj(sgg, s_gh, s_hg, si[GSUM], sj[GSUM],
                                      sj[HSUM], n, si[HSUM], si, sj,
                                      inv_n, adj_c);
          const float d_add = ex.add - e0.add;
          const float aDax = swap ? ex.db : ex.da;
          const float aDa0 = swap ? e0.db : e0.da;
          const float aDbx = swap ? ex.da : ex.db;
          const float aDb0 = swap ? e0.da : e0.db;
          rl2[u] += d_add;
          if (fc & FL_DOM_OK) {
            rl2d[u] += aDax - aDa0;
            rwse[u] += (aDax > rsq ? 1 : 0) - (aDa0 > rsq ? 1 : 0);
          }
          if (cln) {                            // the mirrored credit to c
            cl2 += d_add;
            if (fx[u] & FL_DOM_OK) {
              cl2d += aDbx - aDb0;
              cwse += (aDbx > rsq ? 1 : 0) - (aDb0 > rsq ? 1 : 0);
            }
          }
          if constexpr (ANNOT)
            if (slot >= 0)
              stage(u, j, v, d_add,
                    (fc & FL_DOM_OK) ? aDax - aDa0 : 0.f, cln ? d_add : 0.f,
                    (cln && (fx[u] & FL_DOM_OK)) ? aDbx - aDb0 : 0.f);
        }
        // the column over the warp's 8 row groups, then per warp to
        // shared memory
#pragma unroll
        for (int off = 4; off < 32; off <<= 1) {
          cl2 += __shfl_xor_sync(0xffffffffu, cl2, off);
          cl2d += __shfl_xor_sync(0xffffffffu, cl2d, off);
          cwse += __shfl_xor_sync(0xffffffffu, cwse, off);
        }
        if (gq == 0) {
          es.colf[warp8][0][lc] = cl2;
          es.colf[warp8][1][lc] = cl2d;
          es.coli[warp8][lc] = cwse;
        }
      }

    // the staged column slabs are read by wgmma: fenced before the
    // barrier below publishes them
    if constexpr (ANNOT)
      if (slot >= 0) fence_proxy_async();

    // rows: over the 4 lanes of a quad, then straight out (one warp holds
    // every column of its rows); only the rows the segment owns
#pragma unroll
    for (int off = 1; off < 4; off <<= 1)
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        rl2[u] += __shfl_xor_sync(0xffffffffu, rl2[u], off);
        rl2d[u] += __shfl_xor_sync(0xffffffffu, rl2d[u], off);
        rwse[u] += __shfl_xor_sync(0xffffffffu, rwse[u], off);
      }
    if (tq == 0) {
      const size_t m_pad = static_cast<size_t>(p.m_pad);
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        if (!(fx[u] & FL_OWNED)) continue;
        p.rpart_f[(2 * static_cast<size_t>(ct)) * m_pad + gx[u]] = rl2[u];
        p.rpart_f[(2 * static_cast<size_t>(ct) + 1) * m_pad + gx[u]] =
            rl2d[u];
        p.rpart_i[static_cast<size_t>(ct) * m_pad + gx[u]] = rwse[u];
      }
    }
    asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS) : "memory");

    // columns: the 8 warps' sums in a fixed order
    if (tid < TC && cl0 + tid < P) {
      float f0 = 0.f, f1 = 0.f;
      int vi = 0;
      for (int w = 0; w < 8; ++w) {
        f0 += es.colf[w][0][tid];
        f1 += es.colf[w][1][tid];
        vi += es.coli[w][tid];
      }
      const size_t t = static_cast<size_t>(sg) * gridDim.y + xt;
      p.cpart_f[2 * t * P + cl0 + tid] = f0;
      p.cpart_f[(2 * t + 1) * P + cl0 + tid] = f1;
      p.cpart_i[t * P + cl0 + tid] = vi;
    }

    if constexpr (ANNOT) {
      if (slot >= 0) {
        const float* xv = reinterpret_cast<const float*>(ring + AL::X_VALS);
        const float* at = reinterpret_cast<const float*>(ring + AL::COLS_A);
        float* rout = p.rpart_a + static_cast<size_t>(slot) * 2 * TM * pld;
        float* cout = p.cpart_a + static_cast<size_t>(slot) * TC * 2 * pld;
        const uint32_t rb = ring_s + AL::ROWS_B;
        const uint32_t cb = ring_s + AL::C_SLABS + 2 * wg * AL::C_SLAB;
        float* ro = reinterpret_cast<float*>(ring + AL::ROWS_B);
        for (int q0 = 0; q0 < np; q0 += QS) {
          if (q0 > 0) consumer_sync();   // the last pass's are read
          fetch(q0);
          consumer_sync();
          // mirrored credits: M = the pass's annotations of the x rows
          // (A), N = the TC columns (B, the staged slabs); warpgroup wg
          // the value V_CADD + wg; stored from the accumulator, each
          // lane group a whole sector
          {
            float acc[16];
            tc_chunk<TC, TM, 1, false>(acc, acc, at, nullptr, cb,
                                       cb + AL::C_SLAB, true, wi, lane);
            tc_store_t<TC>(acc, cout + wg * pld + q0, 2 * pld,
                           min(QS, np - q0), wi, lane);
          }
          // credits to x: both values per warpgroup (its 64 rows), held
          // until ROWS_B and COLS_A are read, then staged in their place
          float racc[2][2][16];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int nq = np - q0 - TC_NS * h;
            if (nq <= 0) break;
            with_width<TC_NS>(min(TC_NS, (nq + 7) & ~7), [&](auto W) {
              tc_chunk<decltype(W)::value, TC, 2, true, XLD>(
                  racc[h][0], racc[h][1], xv + 64 * wg * XLD,
                  xv + (TM + 64 * wg) * XLD, rb + 2 * h * AL::R_SLAB,
                  rb + (2 * h + 1) * AL::R_SLAB, true, wi, lane);
            });
          }
          consumer_sync();
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            if (q0 + TC_NS * h >= np) break;
#pragma unroll
            for (int v = 0; v < 2; ++v)
              tc_store2<TC_NS>(racc[h][v],
                               ro + (v * TM + 64 * wg) * AL::OLD + TC_NS * h,
                               AL::OLD, TC_NS, wi, lane);
          }
          consumer_sync();
          // the pass's columns of each row: whole 16-byte words, the rows
          // of a slot contiguous when one pass covers them
          const int w4 = min(QS, pld - q0) / 4;
          for (int i = tid; i < 2 * TM * w4; i += CONSUMERS) {
            const int r = i / w4, c = 4 * (i % w4);
            *reinterpret_cast<float4*>(rout + static_cast<size_t>(r) * pld +
                                       q0 + c) =
                *reinterpret_cast<const float4*>(ro + r * AL::OLD + c);
          }
        }
      }
    }
  }
}

// The annotation partials of a fused launch folded in a fixed order, a
// thread per output float out[v][gx][q]: the row credits over the live
// column tiles of gx's x tile, in order; then, if gx is a contaminated row
// (compact row c), plus its mirrored credits over the segments whose real
// compact columns hold c, in order, and their live x tiles, in order.  No
// atomics: each of the two sums runs from zero in that order.
struct FoldParams {
  const float* rpart;     // [n_live][2][TM][annot_ld(p)]
  const float* cpart;     // [n_live][TC][2][annot_ld(p)]
  const int32_t* slot;    // [n_segs][n_xt][n_ct]
  const int32_t* seg;     // [n_segs][SEG_FIELDS]
  const int32_t* cmap;    // [m_pad]: a row's compact row, or -1
  float* out;             // [2][m_pad][p]
  int n_segs, n_xt, n_ct, S, m_pad, p;
};

__global__ void __launch_bounds__(256) annot_fold_kernel(
    const __grid_constant__ FoldParams f) {
  const size_t total = 2ull * f.m_pad * f.p;
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x;
       i < total; i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const int q = static_cast<int>(i % f.p);
    const size_t vg = i / f.p;
    const int gx = static_cast<int>(vg % f.m_pad);
    const int v = static_cast<int>(vg / f.m_pad);
    const int s = gx / f.S, xl = gx - f.seg[s * SEG_FIELDS];
    const int32_t* sl =
        f.slot + (static_cast<size_t>(s) * f.n_xt + xl / TM) * f.n_ct;
    const int pld = annot_ld(f.p);
    float acc = 0.f;
    for (int ct = 0; ct < f.n_ct; ++ct) {
      const int k = sl[ct];
      if (k >= 0)
        acc += f.rpart[((static_cast<size_t>(k) * 2 + v) * TM + xl % TM) *
                           pld + q];
    }
    const int c = f.cmap[gx];
    if (c >= 0) {
      float col = 0.f;
      for (int t = 0; t < f.n_segs; ++t) {
        const int cl = c - f.seg[t * SEG_FIELDS + 1];
        if (cl < 0 || cl >= f.seg[t * SEG_FIELDS + 2]) continue;
        const int32_t* st = f.slot + static_cast<size_t>(t) * f.n_xt * f.n_ct;
        for (int xt = 0; xt < f.n_xt; ++xt) {
          const int k = st[xt * f.n_ct + cl / TC];
          if (k >= 0)
            col += f.cpart[((static_cast<size_t>(k) * TC + cl % TC) * 2 + v) *
                               pld + q];
        }
      }
      acc += col;
    }
    f.out[i] = acc;
  }
}

// The fused launch's live tiles, a CTA per tile: live[sg][xt][ct] = 1 iff
// a row of it reaches (reaches(), the fused launch's own rule)
__global__ void __launch_bounds__(TM) tile_reach_kernel(
    const int32_t* seg, const int32_t* lo, const int32_t* hi,
    const int32_t* cidx, int rows_a, int32_t* live) {
  const int ct = blockIdx.x, xt = blockIdx.y, sg = blockIdx.z;
  const int32_t* fields = seg + sg * SEG_FIELDS;
  const int any = __syncthreads_or(reaches(fields, fields[0], fields[1], lo,
                                           hi, cidx, rows_a, xt * TM, ct * TC,
                                           threadIdx.x));
  if (threadIdx.x == 0)
    live[(static_cast<size_t>(sg) * gridDim.y + xt) * gridDim.x + ct] = any;
}

template <bool FUSED, bool WITH_H, bool ANNOT, bool BF16>
cudaError_t launch(Params& p, const void* a_mat, int a_rows,
                   const void* const (&b_mat)[3], int b_rows, int n_segs,
                   cudaStream_t stream) {
  constexpr int SMEM = ATOM + STAGES * (STAGE_BYTES + 16) +
                       static_cast<int>(sizeof(EpiSmem));
  static_assert(SMEM <= 232448, "shared memory of one CTA");
  using AL = AnnotLayout;
  static_assert(AL::END <= STAGES * STAGE_BYTES &&
                    AL::OUT_END <= STAGES * STAGE_BYTES &&
                    AL::OLD >= QS && AL::OLD % 4 == 0 &&
                    AL::C_SLABS % ATOM == 0 &&
                    AL::C_SLAB % ATOM == 0 && AL::ROWS_B % ATOM == 0 &&
                    AL::R_SLAB % ATOM == 0 && TC == TC_NS && TM % 64 == 0 &&
                    QS == 64 && CONSUMERS % QS == 0 &&
                    CONSUMERS % TC_NS == 0,
                "the annotation epilogue's regions fit in the ring, its slabs "
                "on swizzle atoms, a column tile one slab's N, a pass one "
                "warpgroup's M");
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  if (!encode<BF16>(fn, &p.tm_a, a_mat, a_rows, p.n_pad, TM))
    return cudaErrorInvalidValue;
  for (int q = 0; q < 3; ++q)
    if (!encode<BF16>(fn, &p.tm_b[q], b_mat[q], b_rows, p.n_pad, TC))
      return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      split_corr_kernel<FUSED, WITH_H, ANNOT, BF16>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return err;
  dim3 grid((p.P + TC - 1) / TC, (p.rows_a + TM - 1) / TM, n_segs);
  split_corr_kernel<FUSED, WITH_H, ANNOT, BF16>
      <<<grid, THREADS, SMEM, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" int split_corr_tiles(int* tm, int* tc) {
  *tm = TM;
  *tc = TC;
  return 0;
}

// floats per row of the annotation partials for p annotations
extern "C" int split_annot_ld(int p) { return annot_ld(p); }

// products mode: for each of n_segs segments (fields in seg, or one
// segment at row 0 when seg is null), x rows a_mat[first x row + i] for
// i < rows_seg against the blocks b_q[c0 + boff_q + c], c < P; a of
// segment s, row i at out_a[(s rows_seg + i) ld_a + q P + c] where that
// column is below ld_a; b likewise for q < 2 when ld_b > 0; bf16 operands
// when bf16 != 0 (every matrix), else int8
extern "C" int split_corr_products_launch(
    const void* a_mat, int a_rows, const void* b0, const void* b1,
    const void* b2, int b_rows, int boff0, int boff1, int boff2,
    const void* seg, int n_segs, int rows_seg, int P, int n_pad, void* out_a,
    int ld_a, void* out_b, int ld_b, int bf16, void* stream) {
  Params p = {};
  p.seg = static_cast<const int32_t*>(seg);
  p.boff[0] = boff0;
  p.boff[1] = boff1;
  p.boff[2] = boff2;
  p.rows_a = rows_seg;
  p.P = P;
  p.n_pad = n_pad;
  p.out_a = static_cast<int32_t*>(out_a);
  p.out_b = static_cast<int32_t*>(out_b);
  p.ld_a = ld_a;
  p.ld_b = ld_b;
  const void* const b[3] = {b0, b1, b2};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (bf16 != 0)
    err = ld_b > 0
              ? launch<false, true, false, true>(p, a_mat, a_rows, b, b_rows,
                                                 n_segs, s)
              : launch<false, false, false, true>(p, a_mat, a_rows, b,
                                                  b_rows, n_segs, s);
  else
    err = ld_b > 0
              ? launch<false, true, false, false>(p, a_mat, a_rows, b, b_rows,
                                                  n_segs, s)
              : launch<false, false, false, false>(p, a_mat, a_rows, b,
                                                   b_rows, n_segs, s);
  return static_cast<int>(err);
}

// fused mode over every segment of the split plan: x rows g[s0 + i],
// i < S, against [g_c; m_c; h_c][c0 + c], c < P; with annot (and annot_c,
// the partials rpart_a and cpart_a, the live tiles' slots tile_slot,
// n_annot >= 1) the annotation delta credits too; g, g_c, m_c, h_c bf16
// when bf16 != 0, else int8
extern "C" int split_corr_fused_launch(
    const void* g, int m_pad, const void* g_c, const void* m_c,
    const void* h_c, int mm_pad, const void* seg, int n_segs, int S, int P,
    int n_pad, const void* d, int p_x, const void* drow, const void* scal,
    const void* lo, const void* hi, const void* usable, const void* dom_ok,
    const void* rowmiss, const void* scal_c, const void* cidx,
    const void* usable_c, const void* dom_ok_c, void* rpart_f,
    void* rpart_i, void* cpart_f, void* cpart_i, const void* annot,
    const void* annot_c, void* rpart_a, void* cpart_a, const void* tile_slot,
    int n_annot,
    int own_hi, float n, float inv_n, float n_padf, float pad_const,
    float adj_c, float rsq, int bf16, void* stream) {
  Params p = {};
  p.seg = static_cast<const int32_t*>(seg);
  p.rows_a = S;
  p.P = P;
  p.n_pad = n_pad;
  p.d = static_cast<const int32_t*>(d);
  p.drow = static_cast<const int32_t*>(drow);
  p.scal = static_cast<const float*>(scal);
  p.lo = static_cast<const int32_t*>(lo);
  p.hi = static_cast<const int32_t*>(hi);
  p.usable = static_cast<const uint8_t*>(usable);
  p.dom_ok = static_cast<const uint8_t*>(dom_ok);
  p.rowmiss = static_cast<const uint8_t*>(rowmiss);
  p.scal_c = static_cast<const float*>(scal_c);
  p.cidx = static_cast<const int32_t*>(cidx);
  p.usable_c = static_cast<const uint8_t*>(usable_c);
  p.dom_ok_c = static_cast<const uint8_t*>(dom_ok_c);
  p.rpart_f = static_cast<float*>(rpart_f);
  p.rpart_i = static_cast<int32_t*>(rpart_i);
  p.cpart_f = static_cast<float*>(cpart_f);
  p.cpart_i = static_cast<int32_t*>(cpart_i);
  p.annot = static_cast<const float*>(annot);
  p.annot_c = static_cast<const float*>(annot_c);
  p.rpart_a = static_cast<float*>(rpart_a);
  p.cpart_a = static_cast<float*>(cpart_a);
  p.tile_slot = static_cast<const int32_t*>(tile_slot);
  p.p = n_annot;
  p.p_x = p_x;
  p.m_pad = m_pad;
  p.own_hi = own_hi;
  p.n = n;
  p.inv_n = inv_n;
  p.n_padf = n_padf;
  p.pad_const = pad_const;
  p.adj_c = adj_c;
  p.rsq = rsq;
  const void* const b[3] = {g_c, m_c, h_c};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (bf16 != 0)
    err = annot != nullptr
              ? launch<true, true, true, true>(p, g, m_pad, b, mm_pad, n_segs,
                                               s)
              : launch<true, true, false, true>(p, g, m_pad, b, mm_pad,
                                                n_segs, s);
  else
    err = annot != nullptr
              ? launch<true, true, true, false>(p, g, m_pad, b, mm_pad,
                                                n_segs, s)
              : launch<true, true, false, false>(p, g, m_pad, b, mm_pad,
                                                 n_segs, s);
  return static_cast<int>(err);
}

// the annotation partials of split_corr_fused_launch (rpart_a, cpart_a,
// tile_slot over n_segs x n_xt x n_ct tiles, the segment fields seg of S
// rows each) folded into out (2, m_pad, p): each row's credits, a
// contaminated row's (cmap: its compact row, else -1) mirrored ones added
extern "C" int split_annot_fold_launch(const void* rpart, const void* cpart,
                                       const void* slot, const void* seg,
                                       const void* cmap, int n_segs,
                                       int n_xt, int n_ct, int S, int m_pad,
                                       int p, void* out, void* stream) {
  FoldParams f = {};
  f.rpart = static_cast<const float*>(rpart);
  f.cpart = static_cast<const float*>(cpart);
  f.slot = static_cast<const int32_t*>(slot);
  f.seg = static_cast<const int32_t*>(seg);
  f.cmap = static_cast<const int32_t*>(cmap);
  f.out = static_cast<float*>(out);
  f.n_segs = n_segs;
  f.n_xt = n_xt;
  f.n_ct = n_ct;
  f.S = S;
  f.m_pad = m_pad;
  f.p = p;
  const size_t total = 2ull * m_pad * p;
  const unsigned blocks = static_cast<unsigned>(
      total / 256 + 1 < 132 * 16 ? total / 256 + 1 : 132 * 16);
  annot_fold_kernel<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(f);
  return static_cast<int>(cudaGetLastError());
}

// the fused launch's live tiles over n_segs segments of S x rows and P
// compact columns (its fields seg, windows lo, hi, compact rows cidx):
// live (n_segs, ceil(S / TM), ceil(P / TC)) int32, 1 where it computes
extern "C" int split_tile_reach_launch(const void* seg, const void* lo,
                                       const void* hi, const void* cidx,
                                       int n_segs, int S, int P, void* live,
                                       void* stream) {
  dim3 grid((P + TC - 1) / TC, (S + TM - 1) / TM, n_segs);
  tile_reach_kernel<<<grid, TM, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(seg), static_cast<const int32_t*>(lo),
      static_cast<const int32_t*>(hi), static_cast<const int32_t*>(cidx), S,
      static_cast<int32_t*>(live));
  return static_cast<int>(cudaGetLastError());
}
