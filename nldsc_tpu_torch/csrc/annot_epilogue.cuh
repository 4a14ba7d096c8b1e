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
// What bounds it: float32 operations, 4 * 2 * p per pair, each as three
// tf32 products, small beside the int8 products, and the shared-memory
// traffic that feeds them.
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
// K2 (split_corr.cu) contracts each live tile once on the same products:
// rows (credits to its 128 x rows: A = the staged values, K = its 32
// compact columns, B = the columns' annotations) as K1's rows, with the
// values TC + 4 words a row (tc_chunk's LD); its mirrored columns
// transposed, since 32 columns are fewer than a warpgroup's M = 64: A = a
// chunk of 64 annotations of the x rows (a float tile read as K1 reads
// its staged columns), K = the 128 x rows, B = the staged column values,
// written split and swizzled by the pass that computes them (slab_offset)
// and N = the 32 columns (tc_store_t writes the transposed accumulator).

#pragma once

#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

namespace nldsc {

constexpr int ANNOT_THREADS = 256;   // the two consumer warpgroups

__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(ANNOT_THREADS) : "memory");
}

// ---- the contraction on the tensor cores ----

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
// Byte offset of B(k, n) in a slab (n < TC_NS, K/32 blocks of TC_NS rows x
// 128 bytes in the 128-byte swizzle); PERM: block row k of each 8 at K
// index (k >> 1) | ((k & 1) << 2)
template <bool PERM>
__device__ __forceinline__ int slab_offset(int k, int n) {
  const int kk = PERM ? (k & ~7) | ((k & 7) >> 1) | ((k & 1) << 2) : k;
  return (kk / 32) * TC_KB + (n / 8) * ATOM + (n % 8) * 128 +
         ((((kk % 32) / 4) ^ (n % 8)) * 16) + (kk % 4) * 4;
}

template <int K, bool PERM, class Row>
__device__ __forceinline__ void load_slab(uint8_t* hi_s, uint8_t* lo_s,
                                          Row row, int q0, int p, int tid) {
  constexpr int PER = K * TC_NS / ANNOT_THREADS, BATCH = PER < 8 ? PER : 8;
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
      const int off = slab_offset<PERM>(k, n);
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
// (shared-memory addresses).  ROWDIR: A(m, k) = v[m * LD + k], v at the
// warpgroup's first row; else A(m, k) = v[k' * LD + m], v at the first of
// the 64 columns, k' the block row that load_slab<K, true> puts at K index
// k.  LD = 4 mod 32 keeps either direction's A loads on 32 banks.  fresh: the first product overwrites the accumulators.  Per k8
// step three products per value; the next step's A fragments are loaded
// and split while they run (two register sets, one group in flight).
template <int N, int K, int NV, bool ROWDIR, int LD = TC_LD>
__device__ __forceinline__ void tc_chunk(float (&acc0)[16],
                                         float (&acc1)[16], const float* v0,
                                         const float* v1, uint32_t hi_s,
                                         uint32_t lo_s, bool fresh, int wi,
                                         int lane) {
  static_assert(NV == 1 || NV == 2, "one or two value tiles");
  static_assert(LD % 32 == 4, "A loads on 32 banks");
  constexpr int KS = K / 8;
  const int gq = lane >> 2, tq = lane & 3;
  const int off = ROWDIR ? (16 * wi + gq) * LD + tq
                         : (2 * tq) * LD + 16 * wi + gq;
  // the A fragment's four elements, from the fragment's first element
  constexpr int D1 = ROWDIR ? 8 * LD : 8;        // a[1]: m + 8
  constexpr int D2 = ROWDIR ? 4 : LD;            // a[2]: k + 4
  constexpr int STEP = ROWDIR ? 8 : 8 * LD;      // the next k8 step
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

// The same accumulator, two adjacent columns a store: out 8-byte aligned
// and ld even, so that a warp writes whole 32-byte sectors (n < nq; the
// column past an odd nq is written too)
template <int N>
__device__ __forceinline__ void tc_store2(const float (&acc)[16], float* out,
                                          size_t ld, int nq, int wi,
                                          int lane) {
  const int gq = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int n = 8 * j + 2 * tq;
      if (n < nq)
        *reinterpret_cast<float2*>(out + (16 * wi + gq + 8 * u) * ld + n) =
            make_float2(acc[4 * j + 2 * u], acc[4 * j + 2 * u + 1]);
    }
}

// The same accumulator transposed: out[n * ld + m] for m < nm (a column
// direction computed with the annotations as M)
template <int N>
__device__ __forceinline__ void tc_store_t(const float (&acc)[16], float* out,
                                          size_t ld, int nm, int wi,
                                          int lane) {
  const int gq = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int v = 0; v < 2; ++v) {
        const int m = 16 * wi + gq + 8 * u;
        if (m < nm) out[(8 * j + 2 * tq + v) * ld + m] = acc[4 * j + 2 * u + v];
      }
}

}  // namespace nldsc
