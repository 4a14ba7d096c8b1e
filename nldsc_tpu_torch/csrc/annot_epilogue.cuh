// Annotation epilogue shared by the LD kernels: partitioned LD scores.
//
// ld_sym.cu (K1) and split_corr.cu (K2, fused mode) credit every counted
// pair once per annotation, weighted by its neighbour's annotation row
// (nldsc_tpu/ld/ld_int8.py::sym_scan_segment, annot branch, and
// nldsc_tpu/ld/ld_split.py::split_corrections, annot branch: four skinny
// contractions per tile).  On the TPU those ran outside any Pallas kernel,
// on the materialised adjusted-r^2 tile; here the tile exists only in the
// kernels' registers, so the contraction lives in their epilogues.
//
// What bounds it: float32 operations on shared-memory operands, 4 * 2 * p
// per pair, small beside the int8 products.  The design keeps the 4 * p
// sums per pair out of the product loop's registers: a kernel stages its
// masked per-pair values (the very floats it adds to the plain credit
// sums) for a block of ROWS x COLS pairs in the shared memory its ring has
// freed, then the 256 consumer threads contract that block with the
// annotation rows of its columns (credits to the rows) and of its rows
// (mirrored credits to the columns), ANNOT_CHUNK annotations at a time.
// Every sum runs in a fixed order and is written as a per-tile partial,
// which the wrapper folds in a fixed order: no float atomics, two runs are
// bitwise equal.

#pragma once

#include <stdint.h>

namespace nldsc {

constexpr int ANNOT_CHUNK = 32;      // annotations contracted per pass: a warp
constexpr int ANNOT_THREADS = 256;   // the two consumer warpgroups

// NV value tiles of ROWS x COLS pairs; rows 16-byte aligned (they are read
// four columns at a time) and four words apart in the banks
template <int ROWS, int COLS, int NV>
struct AnnotValues {
  alignas(16) float v[NV][ROWS][COLS + 4];
};

// one chunk of the annotations of the block's rows and columns
template <int ROWS, int COLS>
struct AnnotChunk {
  float a_rows[ROWS][ANNOT_CHUNK];
  float a_cols[COLS][ANNOT_CHUNK];
};

__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(ANNOT_THREADS) : "memory");
}

// Contract the staged block, all consumer threads together.
//   rows:  out(val, r)[q] (+)= sum_c v[vr[val]][r][c] * annot of column c
//   cols:  out(val, c)[q]   = sum_r v[vc[val]][r][c] * annot of row r
// for val = 0 (additive) and 1 (dominance) and every annotation q < p.
// row_annot(r) / col_annot(c) give the p annotations of a row or column
// of the block, or null (zeros); row_out(val, r) / col_out(val, c) the p
// sums to write, or null (not written).  rows_add adds to what row_out
// holds (a later block of columns of the same rows); with_cols = false
// skips the mirrored direction.  Starts and ends with a barrier of the
// consumer threads: the staged values are complete before, and free after.
//
// A warp's 32 lanes take the 32 annotations of a chunk, and each of the 8
// warps a slab of rows (columns): annotation loads hit 32 banks, value
// loads are broadcasts, and every load and store of the sums in device
// memory is 32 consecutive floats (a thread per row instead made each
// store 32 separate sectors, and the epilogue as long as the products).
template <int ROWS, int COLS, int NV, class RowAnnot, class ColAnnot,
          class RowOut, class ColOut>
__device__ __forceinline__ void annot_contract(
    AnnotValues<ROWS, COLS, NV>& sv, AnnotChunk<ROWS, COLS>& s, int tid,
    int p, const int (&vr)[2], const int (&vc)[2], bool rows_add,
    bool with_cols, RowAnnot row_annot, ColAnnot col_annot, RowOut row_out,
    ColOut col_out) {
  constexpr int WARPS = ANNOT_THREADS / 32;
  constexpr int RPT = ROWS / WARPS, CPT = COLS / WARPS;
  constexpr int RS = 4;
  static_assert(ANNOT_CHUNK == 32 && ROWS % WARPS == 0 && COLS % 4 == 0 &&
                    CPT % 4 == 0 && RPT % RS == 0,
                "a lane per annotation, a warp per slab of rows (columns), "
                "values read four columns at a time");
  const int lane = tid & 31, warp = tid >> 5;
  consumer_sync();
  for (int q0 = 0; q0 < p; q0 += ANNOT_CHUNK) {
    const int q = q0 + lane;
    for (int r = warp; r < ROWS; r += WARPS) {
      const float* a = row_annot(r);
      s.a_rows[r][lane] = (a != nullptr && q < p) ? a[q] : 0.f;
    }
    for (int c = warp; c < COLS; c += WARPS) {
      const float* a = col_annot(c);
      s.a_cols[c][lane] = (a != nullptr && q < p) ? a[q] : 0.f;
    }
    consumer_sync();
    // rows, 4 of the warp's slab at a time: 8 sums and 8 loaded values a thread
    // beside the product accumulators the kernel still holds
#pragma unroll 1
    for (int r0 = warp * RPT; r0 < (warp + 1) * RPT; r0 += RS) {
      float acc[2][RS];
#pragma unroll
      for (int i = 0; i < RS; ++i) acc[0][i] = acc[1][i] = 0.f;
      for (int c = 0; c < COLS; c += 4) {
        const float a[4] = {s.a_cols[c][lane], s.a_cols[c + 1][lane],
                            s.a_cols[c + 2][lane], s.a_cols[c + 3][lane]};
#pragma unroll
        for (int val = 0; val < 2; ++val)
#pragma unroll
          for (int i = 0; i < RS; ++i) {
            const float4 x = *reinterpret_cast<const float4*>(
                &sv.v[vr[val]][r0 + i][c]);
            float t = acc[val][i];
            t = __fmaf_rn(x.x, a[0], t);
            t = __fmaf_rn(x.y, a[1], t);
            t = __fmaf_rn(x.z, a[2], t);
            acc[val][i] = __fmaf_rn(x.w, a[3], t);
          }
      }
      if (q < p) {
#pragma unroll
        for (int val = 0; val < 2; ++val)
#pragma unroll
          for (int i = 0; i < RS; ++i) {
            float* out = row_out(val, r0 + i);
            if (out != nullptr)
              out[q] = rows_add ? out[q] + acc[val][i] : acc[val][i];
          }
      }
    }
    if (with_cols) {
      const int c0 = warp * CPT;
      float acc[2][CPT];
#pragma unroll
      for (int i = 0; i < CPT; ++i) acc[0][i] = acc[1][i] = 0.f;
#pragma unroll 2
      for (int r = 0; r < ROWS; ++r) {
        const float a = s.a_rows[r][lane];
#pragma unroll
        for (int val = 0; val < 2; ++val)
#pragma unroll
          for (int i = 0; i < CPT; i += 4) {
            const float4 x = *reinterpret_cast<const float4*>(
                &sv.v[vc[val]][r][c0 + i]);
            acc[val][i] = __fmaf_rn(x.x, a, acc[val][i]);
            acc[val][i + 1] = __fmaf_rn(x.y, a, acc[val][i + 1]);
            acc[val][i + 2] = __fmaf_rn(x.z, a, acc[val][i + 2]);
            acc[val][i + 3] = __fmaf_rn(x.w, a, acc[val][i + 3]);
          }
      }
      if (q < p) {
#pragma unroll
        for (int val = 0; val < 2; ++val)
#pragma unroll
          for (int i = 0; i < CPT; ++i) {
            float* out = col_out(val, c0 + i);
            if (out != nullptr) out[q] = acc[val][i];
          }
      }
    }
    consumer_sync();
  }
}

}  // namespace nldsc
