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
// of nldsc_tpu/ld/ld_split.py::split_corrections (annot branch): a live
// tile stages its four masked delta values in the freed ring and
// annot_epilogue.cuh contracts them with the annotations of the compact
// columns (credits to x) and of the x rows (mirrored credits), written as
// row and column partials beside the plain ones.  The plain sums of an
// ANNOT launch are those of a plain launch bit for bit.
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
// staged delta tiles of the annotation epilogue: credits to x (additive,
// dominance) and mirrored credits to the compact column
enum { V_XADD, V_XDOM, V_CADD, V_CDOM, V_TILES };
using AnnotTile = AnnotValues<TM, TC, V_TILES>;

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
  // fused mode with annotations (zero-filled by the caller: a tile that
  // skips its products writes none of them)
  const float* annot;      // (m_pad, p)
  const float* annot_c;    // (mm_pad, p), compact order
  float* rpart_a;          // [n_ct][2][m_pad][p]
  float* cpart_a;          // [n_segs][n_xt][2][P][p]
  int p;
  int p_x, m_pad, own_hi;
  float n, inv_n, n_padf, pad_const, adj_c, rsq;   // inv_n = f32(1/n)
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

  // fused mode: a tile counts no pair unless one of the x rows it owns
  // has a window that reaches one of its real compact columns.  Those
  // are sorted, so the first and the last bound them.  Such a tile skips
  // its products and writes zero partials.
  int reach = 1;
  if constexpr (FUSED) {
    const int c_end = min(cl0 + TC, fields[2]);
    const int xl = x0 + tid, gx = a_row0 + xl;
    reach = tid < TM && cl0 < c_end && xl < p.rows_a && gx >= fields[3] &&
            p.lo[gx] <= p.cidx[c0 + c_end - 1] &&
            p.hi[gx] >= p.cidx[c0 + cl0];
  }

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
    auto& as = *reinterpret_cast<AnnotTile*>(ring);
    auto& ac = *reinterpret_cast<AnnotChunk<TM, TC>*>(ring + sizeof(AnnotTile));
    if constexpr (ANNOT) {
      // only counted pairs are staged below: the rest stay zero
      if (live) {
        float* v = &as.v[0][0][0];
        for (int i = tid; i < static_cast<int>(sizeof(AnnotTile) / 4);
             i += CONSUMERS)
          v[i] = 0.f;
        consumer_sync();
      }
    }

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
          if (!pair) continue;
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
          if constexpr (ANNOT) {
            const int lr = row0 + 8 * u;
            as.v[V_XADD][lr][lc] = d_add;
            if (fc & FL_DOM_OK) as.v[V_XDOM][lr][lc] = aDax - aDa0;
            if (cln) {
              as.v[V_CADD][lr][lc] = d_add;
              if (fx[u] & FL_DOM_OK) as.v[V_CDOM][lr][lc] = aDbx - aDb0;
            }
          }
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
      if (live) {
        const size_t np = static_cast<size_t>(p.p);
        const size_t m_pad = static_cast<size_t>(p.m_pad);
        const size_t t = static_cast<size_t>(sg) * gridDim.y + xt;
        annot_contract(
            as, ac, tid, p.p, {V_XADD, V_XDOM}, {V_CADD, V_CDOM},
            [&](int r) {
              return x0 + r < p.rows_a ? p.annot + (gx0 + r) * np : nullptr;
            },
            [&](int c) {
              return cl0 + c < P ? p.annot_c + (c0 + cl0 + c) * np : nullptr;
            },
            [&](int val, int r) {
              return (es.fx[r] & FL_OWNED)
                         ? p.rpart_a + ((2 * ct + val) * m_pad + gx0 + r) * np
                         : nullptr;
            },
            [&](int val, int c) {
              return cl0 + c < P
                         ? p.cpart_a + ((2 * t + val) * P + cl0 + c) * np
                         : nullptr;
            });
      }
    }
  }
}

template <bool FUSED, bool WITH_H, bool ANNOT, bool BF16>
cudaError_t launch(Params& p, const void* a_mat, int a_rows,
                   const void* const (&b_mat)[3], int b_rows, int n_segs,
                   cudaStream_t stream) {
  constexpr int SMEM = ATOM + STAGES * (STAGE_BYTES + 16) +
                       static_cast<int>(sizeof(EpiSmem));
  static_assert(SMEM <= 232448, "shared memory of one CTA");
  static_assert(sizeof(AnnotTile) % 16 == 0 &&
                    sizeof(AnnotTile) + sizeof(AnnotChunk<TM, TC>) <=
                        STAGES * STAGE_BYTES,
                "the staged annotation values and the annotation chunk must "
                "fit in the ring");
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
// the partials rpart_a and cpart_a, n_annot >= 1) the annotation delta
// credits too; g, g_c, m_c, h_c bf16 when bf16 != 0, else int8
extern "C" int split_corr_fused_launch(
    const void* g, int m_pad, const void* g_c, const void* m_c,
    const void* h_c, int mm_pad, const void* seg, int n_segs, int S, int P,
    int n_pad, const void* d, int p_x, const void* drow, const void* scal,
    const void* lo, const void* hi, const void* usable, const void* dom_ok,
    const void* rowmiss, const void* scal_c, const void* cidx,
    const void* usable_c, const void* dom_ok_c, void* rpart_f,
    void* rpart_i, void* cpart_f, void* cpart_i, const void* annot,
    const void* annot_c, void* rpart_a, void* cpart_a, int n_annot,
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
