// Split-missing corrections for Hopper (sm_90a): kernel K2 and the delta
// epilogue.
//
// K2, split_corr_kernel, replaces scripts/pallas_corr_probe.py::kernel
// (launcher corr_pallas), the read-fusing form of the two big launches of
// nldsc_tpu/ld/ld_split.py::split_corrections.  For x rows X (rows_x,
// n_pad) and a compact operand CAT (rows_cat, n_pad), both int8, it
// computes the exact int32 products
//     a = X . CAT^T                      (rows_x, rows_cat)
//     b = h(X) . CAT[:p2]^T              (rows_x, p2), when p2 > 0
// where h(x) = 2 min(x, 1) is derived in registers from the masked codes
// {0, 1, 2}, so h is never read from device memory.  The split engine
// calls it with X = a segment of g and CAT = cat3 = [g_c; m_c; h_c] of the
// contaminated rows in reach (p2 = 2P), and with X = the compact missing
// indicators of the segment's contaminated rows and p2 = 0.
//
// What bounds it on this card: an int8 GEMM with one skinny dimension.
// At the chromosome shape (S = 4,096 x rows, 3P ~ 1,000, n_pad = 16,384)
// cat3 is ~17 MB and stays in the 50 MB L2, while each segment of g is
// 64 MB and should come from device memory once.  The grid runs the CAT
// tiles fastest, so the CTAs that share an X tile run together and read
// it from L2 after the first; cp.async double-buffers 64-sample stages of
// both operands, and mma.sync m16n8k32 s8 -> s32 does the products.
// Ragged edges (rows_x and rows_cat are multiples of 8, not of the tile)
// are zero-filled in shared memory and never stored.
//
// The delta epilogue, split_delta_kernel, evaluates every (x, c) entry of
// a segment four times through pair_epilogue.cuh's pair_adj -- the same
// function the clean pass (ld_sym.cu) uses, so the clean baseline cancels
// that pass's value bit for bit: exact and clean, in the direct (x as i)
// and role-swapped (c as i) orientation.  It selects the orientation,
// applies the masks and the threshold counts of ld_split.py:239-270 and
// writes per-tile row partials (credits to x) and column partials
// (credits to the contaminated rows, compact order), which the wrapper
// folds in a fixed order: no float atomics.

#include <cuda_runtime.h>
#include <stdint.h>

#include "pair_epilogue.cuh"

namespace {

using namespace nldsc;

constexpr int TM = 64;            // X rows per CTA
constexpr int TN = 64;            // CAT rows per CTA
constexpr int KC = 64;            // samples per shared-memory stage
constexpr int LDS = KC + 16;      // padded smem row stride (bytes)
constexpr int WARPS_M = 2, WARPS_N = 2;
constexpr int THREADS = 32 * WARPS_M * WARPS_N;
constexpr int WM = TM / WARPS_M, WN = TN / WARPS_N;
constexpr int MT = WM / 16, NT = WN / 8;

__device__ __forceinline__ void cp_async16_zfill(void* smem, const void* gmem,
                                                 bool valid) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  int src_bytes = valid ? 16 : 0;   // 0: fill the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void mma_s8(int (&d)[4], const unsigned (&a)[4],
                                       const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ unsigned lds32(const int8_t* p) {
  return *reinterpret_cast<const unsigned*>(p);
}

// h = 2 min(x, 1) on four packed codes in {0, 1, 2}: a byte is nonzero
// iff its bit 0 or bit 1 is set
__device__ __forceinline__ unsigned h_of(unsigned v) {
  return ((v | (v >> 1)) & 0x01010101u) << 1;
}

struct CorrParams {
  const int8_t* x;
  const int8_t* cat;
  int32_t* a;
  int32_t* b;
  int rows_x;
  int rows_cat;
  int p2;
  int n_pad;
};

template <bool WITH_H>
__global__ void __launch_bounds__(THREADS) split_corr_kernel(CorrParams p) {
  __shared__ __align__(16) int8_t smem[2][2][TM * LDS];   // stage, operand

  const int j0 = blockIdx.x * TN;   // CAT tiles fastest: X tiles shared
  const int r0 = blockIdx.y * TM;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const int gq = lane >> 2, tq = lane & 3;
  const size_t n_pad = static_cast<size_t>(p.n_pad);
  const bool do_b = WITH_H && j0 < p.p2;

  auto load_stage = [&](int s, int kk) {
    constexpr int CHUNKS = 2 * TM * (KC / 16);
    for (int c = tid; c < CHUNKS; c += THREADS) {
      const int op = c / (TM * (KC / 16));
      const int rem = c % (TM * (KC / 16));
      const int r = rem / (KC / 16), q = rem % (KC / 16);
      const int row = (op == 0 ? r0 : j0) + r;
      const bool valid = row < (op == 0 ? p.rows_x : p.rows_cat);
      const int8_t* mat = op == 0 ? p.x : p.cat;
      const int8_t* src = mat + (valid ? row : 0) * n_pad + kk + q * 16;
      cp_async16_zfill(&smem[s][op][r * LDS + q * 16], src, valid);
    }
  };

  int acc_a[MT][NT][4];
  int acc_b[WITH_H ? MT : 1][WITH_H ? NT : 1][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc_a[i][j][e] = 0;
        if constexpr (WITH_H) acc_b[i][j][e] = 0;
      }

  const int nk = p.n_pad / KC;
  load_stage(0, 0);
  cp_async_commit();
  for (int kc = 0; kc < nk; ++kc) {
    if (kc + 1 < nk) load_stage((kc + 1) & 1, (kc + 1) * KC);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();

    const int8_t* xs = smem[kc & 1][0];
    const int8_t* cs = smem[kc & 1][1];
#pragma unroll
    for (int ks = 0; ks < KC; ks += 32) {
      unsigned af[MT][4], bf[NT][2];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const int8_t* base = xs + (wm * WM + i * 16 + gq) * LDS + ks + tq * 4;
        af[i][0] = lds32(base);
        af[i][1] = lds32(base + 8 * LDS);
        af[i][2] = lds32(base + 16);
        af[i][3] = lds32(base + 8 * LDS + 16);
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int8_t* base = cs + (wn * WN + j * 8 + gq) * LDS + ks + tq * 4;
        bf[j][0] = lds32(base);
        bf[j][1] = lds32(base + 16);
      }
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_s8(acc_a[i][j], af[i], bf[j]);
      if constexpr (WITH_H) {
        if (do_b) {
#pragma unroll
          for (int i = 0; i < MT; ++i) {
            unsigned hf[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) hf[e] = h_of(af[i][e]);
#pragma unroll
            for (int j = 0; j < NT; ++j) mma_s8(acc_b[i][j], hf, bf[j]);
          }
        }
      }
    }
    __syncthreads();
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = r0 + wm * WM + i * 16 + gq + 8 * (e >> 1);
        const int c = j0 + wn * WN + j * 8 + tq * 2 + (e & 1);
        if (r >= p.rows_x) continue;
        if (c < p.rows_cat)
          p.a[static_cast<size_t>(r) * p.rows_cat + c] = acc_a[i][j][e];
        if constexpr (WITH_H) {
          if (do_b && c < p.p2)
            p.b[static_cast<size_t>(r) * p.p2 + c] = acc_b[i][j][e];
        }
      }
}

// ---- delta epilogue ------------------------------------------------------

constexpr int EC = 32;            // c columns per CTA (threadIdx.x)
constexpr int EY = 8;             // threadIdx.y
constexpr int ER = 64;            // x rows per CTA, ER / EY per thread

struct DeltaParams {
  const int32_t* a;         // (S, 3P): sgg | sgm | sgh
  const int32_t* b;         // (S, 2P): shg | shm
  const int32_t* d;         // (p_x, 3P): smg | smm | smh of contaminated x
  const int32_t* drow;      // (S,): row of d for x, or -1
  const float* scal_x;      // (S, NSCAL), the segment's rows
  const float* scal_c;      // (P, NSCAL), compact
  const int32_t* lo_x;
  const int32_t* hi_x;
  const uint8_t* usable_x;
  const uint8_t* dom_ok_x;
  const uint8_t* rowmiss_x;
  const int32_t* cidx;      // (P,) global row of each compact column
  const uint8_t* usable_c;
  const uint8_t* dom_ok_c;
  float* rpart_f;           // [n_ctiles][2 (l2, l2d)][S]
  int32_t* rpart_i;         // [n_ctiles][S] (wse)
  float* cpart_f;           // [n_xtiles][2][P]
  int32_t* cpart_i;         // [n_xtiles][P]
  int S, P, c_cnt, s0, seg_lo, own_hi;
  float n, n_padf, pad_const, adj_c, rsq;
};

__global__ void __launch_bounds__(EC * EY) split_delta_kernel(DeltaParams p) {
  __shared__ float sf[2][EY][EC];
  __shared__ int si[EY][EC];

  const int tx = threadIdx.x, ty = threadIdx.y;
  const int c = blockIdx.x * EC + tx;
  const bool c_in = c < p.P;
  const int P = p.P;
  const float n = p.n, n_padf = p.n_padf, adj_c = p.adj_c, rsq = p.rsq;

  const float* sc = p.scal_c + static_cast<size_t>(c_in ? c : 0) * NSCAL;
  const int gc = c_in ? p.cidx[c] : 0;
  const bool c_ok = c_in && c < p.c_cnt && p.usable_c[c];
  const bool c_dom = c_in && p.dom_ok_c[c];

  float cl2 = 0.f, cl2d = 0.f;
  int cwse = 0;
  for (int k = 0; k < ER / EY; ++k) {
    const int x = blockIdx.y * ER + ty + EY * k;
    if (x >= p.S) break;                       // uniform across the warp
    const int gx = p.s0 + x;
    float rl2 = 0.f, rl2d = 0.f;
    int rwse = 0;
    const bool cln = !p.rowmiss_x[x];
    const bool pair = c_ok && gx >= p.seg_lo && gc != gx &&
                      gc >= p.lo_x[x] && gc <= p.hi_x[x] && p.usable_x[x] &&
                      min(gx, gc) < p.own_hi;
    if (pair) {
      const float* sx = p.scal_x + static_cast<size_t>(x) * NSCAL;
      const size_t ra = static_cast<size_t>(x) * 3 * P;
      const size_t rb = static_cast<size_t>(x) * 2 * P;
      const float sgg = static_cast<float>(p.a[ra + c]);
      const float sgm = static_cast<float>(p.a[ra + P + c]);
      const float sgh = static_cast<float>(p.a[ra + 2 * P + c]);
      const float shg = static_cast<float>(p.b[rb + c]);
      const float shm = static_cast<float>(p.b[rb + P + c]);
      const int dr = p.drow[x];
      float smg = 0.f, smm_d = 0.f, smh = 0.f;
      if (dr >= 0) {
        const size_t rd = static_cast<size_t>(dr) * 3 * P;
        smg = static_cast<float>(p.d[rd + c]);
        smm_d = static_cast<float>(p.d[rd + P + c]);
        smh = static_cast<float>(p.d[rd + 2 * P + c]);
      }
      const float smm = cln ? p.pad_const : smm_d;

      // x as i: exact and clean
      const PairAdj ex = pair_adj(
          sgg, sgh, shg, sx[GSUM] - sgm, sc[GSUM] - smg, sc[HSUM] - smh,
          n_padf - sx[CMISS] - sc[CMISS] + smm, sx[HSUM] - shm, sx, sc, n,
          adj_c);
      const PairAdj e0 = pair_adj(sgg, sgh, shg, sx[GSUM], sc[GSUM],
                                  sc[HSUM], n, sx[HSUM], sx, sc, n, adj_c);
      // c as i, on the role-swapped dots
      const PairAdj sx_ = pair_adj(
          sgg, shg, sgh, sc[GSUM] - smg, sx[GSUM] - sgm, sx[HSUM] - shm,
          n_padf - sc[CMISS] - sx[CMISS] + smm, sc[HSUM] - smh, sc, sx, n,
          adj_c);
      const PairAdj s0_ = pair_adj(sgg, shg, sgh, sc[GSUM], sx[GSUM],
                                   sx[HSUM], n, sc[HSUM], sc, sx, n, adj_c);
      // pass 1 evaluated the pair with its left member as i
      const bool swap = gc < gx;
      const float d_add = swap ? sx_.add - s0_.add : ex.add - e0.add;
      const float aDax = swap ? sx_.db : ex.da, aDa0 = swap ? s0_.db : e0.da;
      const float aDbx = swap ? sx_.da : ex.db, aDb0 = swap ? s0_.da : e0.db;

      rl2 = d_add;
      if (c_dom) {
        rl2d = aDax - aDa0;
        rwse = (aDax > rsq ? 1 : 0) - (aDa0 > rsq ? 1 : 0);
      }
      if (cln) {                                // the mirrored credit to c
        cl2 += d_add;
        if (p.dom_ok_x[x]) {
          cl2d += aDbx - aDb0;
          cwse += (aDbx > rsq ? 1 : 0) - (aDb0 > rsq ? 1 : 0);
        }
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      rl2 += __shfl_xor_sync(0xffffffffu, rl2, off);
      rl2d += __shfl_xor_sync(0xffffffffu, rl2d, off);
      rwse += __shfl_xor_sync(0xffffffffu, rwse, off);
    }
    if (tx == 0) {
      const size_t o = static_cast<size_t>(blockIdx.x) * p.S + x;
      p.rpart_f[2 * static_cast<size_t>(blockIdx.x) * p.S + x] = rl2;
      p.rpart_f[(2 * static_cast<size_t>(blockIdx.x) + 1) * p.S + x] = rl2d;
      p.rpart_i[o] = rwse;
    }
  }

  sf[0][ty][tx] = cl2;
  sf[1][ty][tx] = cl2d;
  si[ty][tx] = cwse;
  __syncthreads();
  if (ty == 0 && c_in) {
    float f0 = 0.f, f1 = 0.f;
    int v = 0;
    for (int y = 0; y < EY; ++y) {
      f0 += sf[0][y][tx];
      f1 += sf[1][y][tx];
      v += si[y][tx];
    }
    const size_t t = blockIdx.y;
    p.cpart_f[2 * t * P + c] = f0;
    p.cpart_f[(2 * t + 1) * P + c] = f1;
    p.cpart_i[t * P + c] = v;
  }
}

}  // namespace

extern "C" int split_corr_tiles(int* tm, int* tn, int* er, int* ec) {
  *tm = TM;
  *tn = TN;
  *er = ER;
  *ec = EC;
  return 0;
}

extern "C" int split_corr_launch(const void* x, const void* cat, void* a,
                                 void* b, int rows_x, int rows_cat, int p2,
                                 int n_pad, void* stream) {
  CorrParams p;
  p.x = static_cast<const int8_t*>(x);
  p.cat = static_cast<const int8_t*>(cat);
  p.a = static_cast<int32_t*>(a);
  p.b = static_cast<int32_t*>(b);
  p.rows_x = rows_x;
  p.rows_cat = rows_cat;
  p.p2 = p2;
  p.n_pad = n_pad;
  dim3 grid((rows_cat + TN - 1) / TN, (rows_x + TM - 1) / TM);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p2 > 0)
    split_corr_kernel<true><<<grid, THREADS, 0, s>>>(p);
  else
    split_corr_kernel<false><<<grid, THREADS, 0, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int split_delta_launch(
    const void* a, const void* b, const void* d, const void* drow,
    const void* scal_x, const void* scal_c, const void* lo_x,
    const void* hi_x, const void* usable_x, const void* dom_ok_x,
    const void* rowmiss_x, const void* cidx, const void* usable_c,
    const void* dom_ok_c, void* rpart_f, void* rpart_i, void* cpart_f,
    void* cpart_i, int S, int P, int c_cnt, int s0, int seg_lo, int own_hi,
    float n, float n_padf, float pad_const, float adj_c, float rsq,
    void* stream) {
  DeltaParams p;
  p.a = static_cast<const int32_t*>(a);
  p.b = static_cast<const int32_t*>(b);
  p.d = static_cast<const int32_t*>(d);
  p.drow = static_cast<const int32_t*>(drow);
  p.scal_x = static_cast<const float*>(scal_x);
  p.scal_c = static_cast<const float*>(scal_c);
  p.lo_x = static_cast<const int32_t*>(lo_x);
  p.hi_x = static_cast<const int32_t*>(hi_x);
  p.usable_x = static_cast<const uint8_t*>(usable_x);
  p.dom_ok_x = static_cast<const uint8_t*>(dom_ok_x);
  p.rowmiss_x = static_cast<const uint8_t*>(rowmiss_x);
  p.cidx = static_cast<const int32_t*>(cidx);
  p.usable_c = static_cast<const uint8_t*>(usable_c);
  p.dom_ok_c = static_cast<const uint8_t*>(dom_ok_c);
  p.rpart_f = static_cast<float*>(rpart_f);
  p.rpart_i = static_cast<int32_t*>(rpart_i);
  p.cpart_f = static_cast<float*>(cpart_f);
  p.cpart_i = static_cast<int32_t*>(cpart_i);
  p.S = S;
  p.P = P;
  p.c_cnt = c_cnt;
  p.s0 = s0;
  p.seg_lo = seg_lo;
  p.own_hi = own_hi;
  p.n = n;
  p.n_padf = n_padf;
  p.pad_const = pad_const;
  p.adj_c = adj_c;
  p.rsq = rsq;
  dim3 grid((P + EC - 1) / EC, (S + ER - 1) / ER);
  dim3 block(EC, EY);
  split_delta_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      p);
  return static_cast<int>(cudaGetLastError());
}
