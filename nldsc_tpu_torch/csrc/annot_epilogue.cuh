// Annotation epilogues of the LD kernels: partitioned LD scores.
//
// ld_sym.cu (K1) and split_corr.cu (K2, fused mode) credit every counted
// pair once per annotation, weighted by its neighbour's annotation row
// (nldsc_tpu/ld/ld_int8.py::sym_scan_segment, annot branch, and
// nldsc_tpu/ld/ld_split.py::split_corrections, annot branch: four skinny
// contractions per tile).  On the TPU those ran outside any Pallas kernel,
// on the materialised adjusted-r^2 tile; here the tile exists only in the
// kernels' registers, so the contraction lives in their epilogues.  A
// kernel stages its masked per-pair values (the very floats it adds to the
// plain credit sums) in the shared memory its ring has freed and contracts
// them with the annotation rows of its columns (credits to the rows) and
// of its rows (mirrored credits to the columns).  Every sum runs in a
// fixed order and is written once as a per-tile partial, which the wrapper
// folds in a fixed order: no float atomics, two runs are bitwise equal.
//
// What bounds it: float32 operations, 4 * 2 * p per pair, small beside the
// int8 products, and the shared-memory traffic that feeds them.
//
// K1 (tc_chunk and its helpers): the contraction runs on the tensor cores,
// wgmma.m64nNk8.f32.tf32.tf32, float32 accuracy kept by splitting both
// operands into tf32 hi + lo and summing three products, lo.hi + hi.lo +
// hi.hi, in float32 accumulators (the Hopper counterpart of the
// reference's precision='high' contraction, nldsc_tpu/ld/ld_int8.py:707).
// The staged values are operand A, read from shared memory into registers
// and split there, so one float32 copy serves both directions: rows
// (A(m, k) = v[m][k], m a pivot row, k a neighbour column) and mirrored
// columns (A(m, k) = v[k][m]).  The annotations are operand B: a chunk of
// TC_NS annotations of the block's K rows, split into a hi and a lo slab,
// K-major in the 128-byte swizzle, loaded once per block and chunk with
// plain loads (the split needs the values in registers: a TMA or cp.async
// copy would land them unsplit).  N is the chunk's annotations rounded up
// to 8, so p = 53 runs N = 32 + 24.
//
// K2 (annot_contract, below): the contraction on CUDA cores, K2's alone:
// its staged tile is the live TM x TC block of a segment, whose rows and
// columns come from different matrices, and it contracts each tile once.

#pragma once

#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

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

// ---- K2: the contraction on CUDA cores ----

// K2's contraction of its staged block, all consumer threads together.
//   rows:  out(val, r)[q] = sum_c v[vr[val]][r][c] * annot of column c
//   cols:  out(val, c)[q] = sum_r v[vc[val]][r][c] * annot of row r
// for val = 0 (additive) and 1 (dominance) and every annotation q < p.
// row_annot(r) / col_annot(c) give the p annotations of a row or column
// of the block, or null (zeros); row_out(val, r) / col_out(val, c) the p
// sums to write, or null (not written).  Starts and ends with a barrier
// of the consumer threads: the staged values are complete before, and
// free after.
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
    int p, const int (&vr)[2], const int (&vc)[2], RowAnnot row_annot,
    ColAnnot col_annot, RowOut row_out, ColOut col_out) {
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
            if (out != nullptr) out[q] = acc[val][i];
          }
      }
    }
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
    consumer_sync();
  }
}

// ---- K1: the contraction on the tensor cores ----

constexpr int TC_NS = 32;   // annotations per chunk: the rows of a B slab
constexpr int TC_LD = 68;   // words per staged row: 64 values and 4 apart,
                            // so that both directions' A loads hit 32 banks
constexpr int TC_KB = TC_NS * 128;   // bytes of a slab's 32-column K block

// a staged tile of ROWS x 64 values, TC_LD words a row
template <int ROWS>
__host__ __device__ constexpr int tc_tile_bytes() {
  return ROWS * TC_LD * 4;
}

// bytes of one (hi or lo) slab of K rows
template <int K>
__host__ __device__ constexpr int tc_slab_bytes() {
  return (K / 32) * TC_KB;
}

template <int I, int N, class F>
__device__ __forceinline__ void static_for(F&& f) {
  if constexpr (I < N) {
    f(std::integral_constant<int, I>{});
    static_for<I + 1, N>(f);
  }
}

// f(integral_constant<N>) for the chunk width n (a multiple of 8, at most
// CAP)
template <int CAP, class F>
__device__ __forceinline__ void with_width(int n, F&& f) {
  static_assert(CAP % 8 == 0 && CAP >= 8 && CAP <= TC_NS, "chunk widths");
  if (n == 8) f(std::integral_constant<int, 8>{});
  if constexpr (CAP >= 16)
    if (n == 16) f(std::integral_constant<int, 16>{});
  if constexpr (CAP >= 24)
    if (n == 24) f(std::integral_constant<int, 24>{});
  if constexpr (CAP >= 32)
    if (n == 32) f(std::integral_constant<int, 32>{});
}

// The B operand of one chunk, all consumer threads together: annotations
// [q0, q0 + TC_NS) of the block's K rows (row(k): the row's annotations,
// or null for zeros; annotations past p are zeros), split into tf32 hi and
// lo slabs at hi_s and lo_s (1024-byte aligned), each K/32 blocks of
// TC_NS rows x 128 bytes in the 128-byte swizzle.  PERM stores row k of
// each 8 at K index (k >> 1) | ((k & 1) << 2), the order of the column
// direction's A fragments.  A thread issues its loads 8 at a time before
// it splits and stores them.  Ends with the proxy fence; the caller's
// barrier then publishes the slabs.
template <int K, bool PERM, class Row>
__device__ __forceinline__ void load_slab(uint8_t* hi_s, uint8_t* lo_s,
                                          Row row, int q0, int p, int tid) {
  constexpr int PER = K * TC_NS / ANNOT_THREADS, BATCH = 8;
  static_assert(PER % BATCH == 0, "whole batches of loads");
  const int n = tid % TC_NS;       // the same annotation for every element
  const bool live = q0 + n < p;
#pragma unroll
  for (int b0 = 0; b0 < PER; b0 += BATCH) {
    float x[BATCH];
#pragma unroll
    for (int i = 0; i < BATCH; ++i) {
      const int k = (tid + (b0 + i) * ANNOT_THREADS) / TC_NS;
      const float* a = row(k);
      x[i] = (a != nullptr && live) ? a[q0 + n] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < BATCH; ++i) {
      const int k = (tid + (b0 + i) * ANNOT_THREADS) / TC_NS;
      uint32_t h, l;
      split_tf32(x[i], h, l);
      const int kk = PERM ? (k & ~7) | ((k & 7) >> 1) | ((k & 1) << 2) : k;
      const int off = (kk / 32) * TC_KB + (n / 8) * ATOM + (n % 8) * 128 +
                      ((((kk % 32) / 4) ^ (n % 8)) * 16) + (kk % 4) * 4;
      *reinterpret_cast<uint32_t*>(hi_s + off) = h;
      *reinterpret_cast<uint32_t*>(lo_s + off) = l;
    }
  }
  fence_proxy_async();
}

template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[16]) {
#pragma unroll
  for (int i = 0; i < N / 2; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// keep the fragments' registers unchanged up to here (a product still
// reads them)
template <int NV>
__device__ __forceinline__ void hold_frags(const uint32_t (&h)[NV][4],
                                           const uint32_t (&l)[NV][4]) {
#pragma unroll
  for (int v = 0; v < NV; ++v)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      asm volatile("" ::"r"(h[v][i]), "r"(l[v][i]) : "memory");
}

// One warpgroup: acc_v (64 x N) (+)= A_v (64 x K) . B (K x N) for the NV
// (1 or 2) value tiles v0 (, v1), B the chunk's slabs at hi_s / lo_s
// (shared-memory addresses).  ROWDIR: A(m, k) = v[m * TC_LD + k], v at the
// warpgroup's first row; else A(m, k) = v[k' * TC_LD + m], v at the first
// of the 64 columns, k' the block row that load_slab<K, true> puts at K
// index k.  fresh: the first product overwrites the accumulators.  Per k8
// step three products per value; the next step's A fragments are loaded
// and split while they run (two register sets, one group in flight).
template <int N, int K, int NV, bool ROWDIR>
__device__ __forceinline__ void tc_chunk(float (&acc0)[16],
                                         float (&acc1)[16], const float* v0,
                                         const float* v1, uint32_t hi_s,
                                         uint32_t lo_s, bool fresh, int wi,
                                         int lane) {
  static_assert(NV == 1 || NV == 2, "one or two value tiles");
  constexpr int KS = K / 8;
  const int gq = lane >> 2, tq = lane & 3;
  const int off = ROWDIR ? (16 * wi + gq) * TC_LD + tq
                         : (2 * tq) * TC_LD + 16 * wi + gq;
  // the A fragment's four elements, from the fragment's first element
  constexpr int D1 = ROWDIR ? 8 * TC_LD : 8;        // a[1]: m + 8
  constexpr int D2 = ROWDIR ? 4 : TC_LD;            // a[2]: k + 4
  constexpr int STEP = ROWDIR ? 8 : 8 * TC_LD;      // the next k8 step
  uint32_t ah[2][NV][4], al[2][NV][4];
  auto load = [&](int ks, uint32_t (&h)[NV][4], uint32_t (&l)[NV][4]) {
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const float* x = (v == 0 ? v0 : v1) + off + ks * STEP;
      const float e[4] = {x[0], x[D1], x[D2], x[D1 + D2]};
#pragma unroll
      for (int i = 0; i < 4; ++i) split_tf32(e[i], h[v][i], l[v][i]);
    }
  };
  load(0, ah[0], al[0]);
  fence_acc<N>(acc0);
  if constexpr (NV == 2) fence_acc<N>(acc1);
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    const int b = ks & 1;
    const uint32_t kb = (ks / 4) * TC_KB;
    const uint64_t dh = smem_desc(hi_s + kb) + 2 * (ks % 4);
    const uint64_t dl = smem_desc(lo_s + kb) + 2 * (ks % 4);
    const int sc = (fresh && ks == 0) ? 0 : 1;
    wgmma_fence();
    wgmma_tf32<N>(acc0, al[b][0], dh, sc);
    wgmma_tf32<N>(acc0, ah[b][0], dl, 1);
    wgmma_tf32<N>(acc0, ah[b][0], dh, 1);
    if constexpr (NV == 2) {
      wgmma_tf32<N>(acc1, al[b][1], dh, sc);
      wgmma_tf32<N>(acc1, ah[b][1], dl, 1);
      wgmma_tf32<N>(acc1, ah[b][1], dh, 1);
    }
    wgmma_commit();
    if (ks + 1 < KS) {
      wgmma_wait<1>();           // the step before: its set is free
      load(ks + 1, ah[b ^ 1], al[b ^ 1]);
      hold_frags<NV>(ah[b], al[b]);
    }
  }
  wgmma_wait_all();
  fence_acc<N>(acc0);
  if constexpr (NV == 2) fence_acc<N>(acc1);
}

// A warpgroup's 64 x N accumulator to out[m * ld + n] for n < nq (out at
// the block's first row and the chunk's first annotation; null: nothing)
template <int N>
__device__ __forceinline__ void tc_store(const float (&acc)[16], float* out,
                                         size_t ld, int nq, int wi,
                                         int lane) {
  if (out == nullptr) return;
  const int gq = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int v = 0; v < 2; ++v) {
        const int n = 8 * j + 2 * tq + v;
        if (n < nq)
          out[(16 * wi + gq + 8 * u) * ld + n] = acc[4 * j + 2 * u + v];
      }
}

}  // namespace nldsc
