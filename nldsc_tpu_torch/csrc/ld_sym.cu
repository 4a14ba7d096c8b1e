// Fused symmetric int8 LD kernel for Hopper (sm_90a).
//
// Replaces nldsc_tpu/ld/ld_pallas_sym.py::_kernel (the TPU's fused
// symmetric Pallas kernel).  One CTA takes a 64-row pivot tile b and a
// 64-row neighbour tile t >= b of the right half-band, accumulates the
// exact int8 x int8 -> int32 products over the whole sample axis
// (Sgg, Sgh, Shg; plus Sgm, Smg, Smm, Smh, Shm when genotypes are
// missing) with mma.sync m16n8k32 on the tensor cores, and runs the
// whole epilogue in registers: corr_from_dots, adjusted r^2, the window,
// usable, dom_ok and poison masks, and the row and mirrored column sums.
//
// What bounds it: at chromosome shapes (N ~ 16k samples, windows of
// ~2000 SNPs) the work is int8 tensor-core operations -- every operand
// byte loaded into shared memory feeds 64 products per product matrix.
// The design keeps everything after the products out of device memory:
// no (B x W) correlation tile is ever written; a CTA writes only its
// 64-entry row and column partial sums, which a fixed-order reduction
// outside the kernel folds (no float atomics, so run-to-run results are
// bitwise equal).
//
// The per-pair expressions live in pair_epilogue.cuh, shared with the
// split engine's delta epilogue (split_corr.cu).  They follow the float32
// operation order of corr_from_dots (nldsc_tpu_torch/ld/ld_int8.py);
// built with -fmad=false, each pair's values equal the plain twin's bit
// for bit, so the WSE threshold count agrees exactly.
//
// Layouts: g, m, h int8 (M_pad, N_pad) row-major; scal f32 (M_pad, 9);
// lo, hi int32 (M_pad); usable, dom_ok, poison uint8 (M_pad); tile_hi
// int32 (M_pad / 64), the last neighbour tile of each pivot tile.
// Partial outputs (zero-filled by the caller):
//   fpart f32  [n_tiles][band][2 (row, col)][2 (l2, l2d)][64]
//   ipart int32[n_tiles][band][2 (row, col)][4 (ws, wsd, wse, poison)][64]

#include <cuda_runtime.h>
#include <stdint.h>

#include "pair_epilogue.cuh"

namespace {

using namespace nldsc;

constexpr int TILE = 64;          // pivot rows = neighbour rows per CTA
constexpr int KC = 64;            // samples per shared-memory stage
constexpr int LDS = KC + 16;      // padded smem row stride (bytes)
enum { OG, OH, OM };              // operand slots: g, h, m
enum { FL_USABLE = 1, FL_DOM_OK = 2, FL_POISON = 4 };

struct Params {
  const int8_t* g;
  const int8_t* m;
  const int8_t* h;
  const float* scal;
  const int32_t* lo;
  const int32_t* hi;
  const uint8_t* usable;
  const uint8_t* dom_ok;
  const uint8_t* poison;
  const int32_t* tile_hi;
  float* fpart;
  int32_t* ipart;
  int n_tiles;
  int band;
  int n_pad;
  float n;
  float n_padf;
  float adj_c;
  float rsq_thr;
};

template <bool MISSING>
struct Cfg {
  static constexpr int WARPS_M = 2;
  static constexpr int WARPS_N = MISSING ? 4 : 2;
  static constexpr int THREADS = 32 * WARPS_M * WARPS_N;
  static constexpr int WM = TILE / WARPS_M;   // rows per warp
  static constexpr int WN = TILE / WARPS_N;   // cols per warp
  static constexpr int MT = WM / 16;          // m16 tiles per warp
  static constexpr int NT = WN / 8;           // n8 tiles per warp
  static constexpr int NSIDE = MISSING ? 3 : 2;   // operands per side
  static constexpr int NOPS = 2 * NSIDE;
  static constexpr int NPROD = MISSING ? 8 : 3;
  static constexpr int STAGE_BYTES = NOPS * TILE * LDS;
  static constexpr int SMEM_BYTES = 2 * STAGE_BYTES;
};

// products in the order sgg, sgh, shg, sgm, smg, smm, smh, shm;
// prod_a / prod_b name their pivot and neighbour operands (constant
// after unrolling, so the fragment arrays stay in registers)
enum { P_GG, P_GH, P_HG, P_GM, P_MG, P_MM, P_MH, P_HM };
__device__ __forceinline__ constexpr int prod_a(int pr) {
  return (pr == P_HG || pr == P_HM) ? OH
         : (pr == P_MG || pr == P_MM || pr == P_MH) ? OM : OG;
}
__device__ __forceinline__ constexpr int prod_b(int pr) {
  return (pr == P_GH || pr == P_MH) ? OH
         : (pr == P_GM || pr == P_MM || pr == P_HM) ? OM : OG;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
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

template <int WARPS_M, int WARPS_N>
struct EpiSmem {
  float si[TILE][NSCAL];
  float sj[TILE][NSCAL];
  int lo[TILE];
  int hi[TILE];
  unsigned char fi[TILE];
  unsigned char fj[TILE];
  float rowf[WARPS_N][2][TILE];
  int rowi[WARPS_N][4][TILE];
  float colf[WARPS_M][2][TILE];
  int coli[WARPS_M][4][TILE];
};

template <bool MISSING>
__global__ void __launch_bounds__(Cfg<MISSING>::THREADS)
    ld_sym_kernel(Params p) {
  using C = Cfg<MISSING>;
  extern __shared__ __align__(16) int8_t smem[];

  const int k = blockIdx.x;
  const int b = blockIdx.y;
  const int t = b + k;
  if (t >= p.n_tiles || t > p.tile_hi[b]) return;   // outside the band

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int wm = warp / C::WARPS_N, wn = warp % C::WARPS_N;
  const int gq = lane >> 2, tq = lane & 3;
  const int r0 = b * TILE, c0 = t * TILE;
  const size_t n_pad = static_cast<size_t>(p.n_pad);

  // stage s <- samples [kk, kk + KC) of the 2*NSIDE operand tiles
  auto load_stage = [&](int s, int kk) {
    constexpr int CHUNKS = C::NOPS * TILE * (KC / 16);
    for (int c = tid; c < CHUNKS; c += C::THREADS) {
      const int op = c / (TILE * (KC / 16));
      const int rem = c % (TILE * (KC / 16));
      const int r = rem / (KC / 16), q = rem % (KC / 16);
      const int side = op / C::NSIDE, which = op % C::NSIDE;
      const int row = (side == 0 ? r0 : c0) + r;
      const int8_t* mat = which == OG ? p.g : (which == OH ? p.h : p.m);
      const int8_t* src = mat + row * n_pad + kk + q * 16;
      int8_t* dst = smem + s * C::STAGE_BYTES + (op * TILE + r) * LDS + q * 16;
      cp_async16(dst, src);
    }
  };

  int acc[C::NPROD][C::MT][C::NT][4];
#pragma unroll
  for (int pr = 0; pr < C::NPROD; ++pr)
#pragma unroll
    for (int i = 0; i < C::MT; ++i)
#pragma unroll
      for (int j = 0; j < C::NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[pr][i][j][e] = 0;

  const int nk = p.n_pad / KC;
  load_stage(0, 0);
  cp_async_commit();
  for (int kc = 0; kc < nk; ++kc) {
    if (kc + 1 < nk) load_stage((kc + 1) & 1, (kc + 1) * KC);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();

    const int8_t* st = smem + (kc & 1) * C::STAGE_BYTES;
#pragma unroll
    for (int ks = 0; ks < KC; ks += 32) {
      unsigned af[C::NSIDE][C::MT][4];
      unsigned bf[C::NSIDE][C::NT][2];
#pragma unroll
      for (int o = 0; o < C::NSIDE; ++o) {
        const int8_t* a_t = st + o * TILE * LDS;
        const int8_t* b_t = st + (C::NSIDE + o) * TILE * LDS;
#pragma unroll
        for (int i = 0; i < C::MT; ++i) {
          const int row = wm * C::WM + i * 16 + gq;
          const int8_t* base = a_t + row * LDS + ks + tq * 4;
          af[o][i][0] = lds32(base);
          af[o][i][1] = lds32(base + 8 * LDS);
          af[o][i][2] = lds32(base + 16);
          af[o][i][3] = lds32(base + 8 * LDS + 16);
        }
#pragma unroll
        for (int j = 0; j < C::NT; ++j) {
          const int col = wn * C::WN + j * 8 + gq;
          const int8_t* base = b_t + col * LDS + ks + tq * 4;
          bf[o][j][0] = lds32(base);
          bf[o][j][1] = lds32(base + 16);
        }
      }
#pragma unroll
      for (int pr = 0; pr < C::NPROD; ++pr)
#pragma unroll
        for (int i = 0; i < C::MT; ++i)
#pragma unroll
          for (int j = 0; j < C::NT; ++j)
            mma_s8(acc[pr][i][j], af[prod_a(pr)][i], bf[prod_b(pr)][j]);
    }
    __syncthreads();
  }
  cp_async_wait<0>();
  __syncthreads();

  // ---- epilogue: everything below stays in registers / shared memory
  using E = EpiSmem<C::WARPS_M, C::WARPS_N>;
  E& es = *reinterpret_cast<E*>(smem);
  for (int c = tid; c < TILE * NSCAL; c += C::THREADS) {
    es.si[c / NSCAL][c % NSCAL] = p.scal[static_cast<size_t>(r0) * NSCAL + c];
    es.sj[c / NSCAL][c % NSCAL] = p.scal[static_cast<size_t>(c0) * NSCAL + c];
  }
  for (int r = tid; r < TILE; r += C::THREADS) {
    es.lo[r] = p.lo[r0 + r];
    es.hi[r] = p.hi[r0 + r];
    es.fi[r] = (p.usable[r0 + r] ? FL_USABLE : 0) |
               (p.dom_ok[r0 + r] ? FL_DOM_OK : 0) |
               (p.poison[r0 + r] ? FL_POISON : 0);
    es.fj[r] = (p.usable[c0 + r] ? FL_USABLE : 0) |
               (p.dom_ok[c0 + r] ? FL_DOM_OK : 0) |
               (p.poison[c0 + r] ? FL_POISON : 0);
  }
  __syncthreads();

  const bool diag = (t == b);   // mirrored credits only past the pivot tile
  const float n = p.n, adj_c = p.adj_c, rsq = p.rsq_thr;

  float rl2[C::MT][2], rl2d[C::MT][2];
  int rws[C::MT][2], rwsd[C::MT][2], rwse[C::MT][2], rpoi[C::MT][2];
  float cl2[C::NT][2], cl2d[C::NT][2];
  int cws[C::NT][2], cwsd[C::NT][2], cwse[C::NT][2], cpoi[C::NT][2];
#pragma unroll
  for (int i = 0; i < C::MT; ++i)
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      rl2[i][u] = 0.f; rl2d[i][u] = 0.f;
      rws[i][u] = 0; rwsd[i][u] = 0; rwse[i][u] = 0; rpoi[i][u] = 0;
    }
#pragma unroll
  for (int j = 0; j < C::NT; ++j)
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      cl2[j][u] = 0.f; cl2d[j][u] = 0.f;
      cws[j][u] = 0; cwsd[j][u] = 0; cwse[j][u] = 0; cpoi[j][u] = 0;
    }

#pragma unroll
  for (int i = 0; i < C::MT; ++i)
#pragma unroll
    for (int j = 0; j < C::NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ui = e >> 1, uj = e & 1;      // C fragment layout
        const int lr = wm * C::WM + i * 16 + gq + 8 * ui;
        const int lc = wn * C::WN + j * 8 + tq * 2 + uj;
        const int gi = r0 + lr, gj = c0 + lc;
        const float* si = es.si[lr];
        const float* sj = es.sj[lc];
        const unsigned fi = es.fi[lr], fj = es.fj[lc];

        const float sgg = static_cast<float>(acc[P_GG][i][j][e]);
        const float sgh = static_cast<float>(acc[P_GH][i][j][e]);
        const float shg = static_cast<float>(acc[P_HG][i][j][e]);
        float sgu, sug, suh, suu, shu;
        if constexpr (MISSING) {
          sgu = si[GSUM] - static_cast<float>(acc[P_GM][i][j][e]);
          sug = sj[GSUM] - static_cast<float>(acc[P_MG][i][j][e]);
          suh = sj[HSUM] - static_cast<float>(acc[P_MH][i][j][e]);
          suu = p.n_padf - si[CMISS] - sj[CMISS] +
                static_cast<float>(acc[P_MM][i][j][e]);
          shu = si[HSUM] - static_cast<float>(acc[P_HM][i][j][e]);
        } else {
          sgu = si[GSUM];
          sug = sj[GSUM];
          suh = sj[HSUM];
          suu = n;
          shu = si[HSUM];
        }
        const PairAdj v = pair_adj(sgg, sgh, shg, sgu, sug, suh, suu, shu,
                                   si, sj, n, adj_c);
        const float adj_add = v.add, adj_da = v.da, adj_db = v.db;

        const bool upair = gj >= es.lo[lr] && gj <= es.hi[lr] &&
                           (fi & FL_USABLE) && (fj & FL_USABLE);
        const bool row_base = upair && gj != gi;
        const bool col_base = upair && !diag;
        const bool dm_a = row_base && (fj & FL_DOM_OK);
        const bool dm_b = col_base && (fi & FL_DOM_OK);

        if (row_base) { rl2[i][ui] += adj_add; rws[i][ui] += 1; }
        if (dm_a) {
          rl2d[i][ui] += adj_da;
          rwsd[i][ui] += 1;
          rwse[i][ui] += adj_da > rsq ? 1 : 0;
        }
        if (upair && (fj & FL_POISON)) rpoi[i][ui] += 1;
        if (col_base) {
          cl2[j][uj] += adj_add;
          cws[j][uj] += 1;
          if (fi & FL_POISON) cpoi[j][uj] += 1;
        }
        if (dm_b) {
          cl2d[j][uj] += adj_db;
          cwsd[j][uj] += 1;
          cwse[j][uj] += adj_db > rsq ? 1 : 0;
        }
      }

  // rows: reduce over the 4 lanes of a quad, then over WARPS_N warps
#pragma unroll
  for (int i = 0; i < C::MT; ++i)
#pragma unroll
    for (int u = 0; u < 2; ++u) {
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        rl2[i][u] += __shfl_xor_sync(0xffffffffu, rl2[i][u], off);
        rl2d[i][u] += __shfl_xor_sync(0xffffffffu, rl2d[i][u], off);
        rws[i][u] += __shfl_xor_sync(0xffffffffu, rws[i][u], off);
        rwsd[i][u] += __shfl_xor_sync(0xffffffffu, rwsd[i][u], off);
        rwse[i][u] += __shfl_xor_sync(0xffffffffu, rwse[i][u], off);
        rpoi[i][u] += __shfl_xor_sync(0xffffffffu, rpoi[i][u], off);
      }
      if (tq == 0) {
        const int lr = wm * C::WM + i * 16 + gq + 8 * u;
        es.rowf[wn][0][lr] = rl2[i][u];
        es.rowf[wn][1][lr] = rl2d[i][u];
        es.rowi[wn][0][lr] = rws[i][u];
        es.rowi[wn][1][lr] = rwsd[i][u];
        es.rowi[wn][2][lr] = rwse[i][u];
        es.rowi[wn][3][lr] = rpoi[i][u];
      }
    }
  // columns: reduce over the 8 quads of a warp, then over WARPS_M warps
#pragma unroll
  for (int j = 0; j < C::NT; ++j)
#pragma unroll
    for (int u = 0; u < 2; ++u) {
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        cl2[j][u] += __shfl_xor_sync(0xffffffffu, cl2[j][u], off);
        cl2d[j][u] += __shfl_xor_sync(0xffffffffu, cl2d[j][u], off);
        cws[j][u] += __shfl_xor_sync(0xffffffffu, cws[j][u], off);
        cwsd[j][u] += __shfl_xor_sync(0xffffffffu, cwsd[j][u], off);
        cwse[j][u] += __shfl_xor_sync(0xffffffffu, cwse[j][u], off);
        cpoi[j][u] += __shfl_xor_sync(0xffffffffu, cpoi[j][u], off);
      }
      if (gq == 0) {
        const int lc = wn * C::WN + j * 8 + tq * 2 + u;
        es.colf[wm][0][lc] = cl2[j][u];
        es.colf[wm][1][lc] = cl2d[j][u];
        es.coli[wm][0][lc] = cws[j][u];
        es.coli[wm][1][lc] = cwsd[j][u];
        es.coli[wm][2][lc] = cwse[j][u];
        es.coli[wm][3][lc] = cpoi[j][u];
      }
    }
  __syncthreads();

  const size_t slot = static_cast<size_t>(b) * p.band + k;
  float* fout = p.fpart + slot * (2 * 2 * TILE);
  int32_t* iout = p.ipart + slot * (2 * 4 * TILE);
  for (int c = tid; c < 2 * TILE; c += C::THREADS) {
    const int dir = c / TILE, r = c % TILE;
    float f[2] = {0.f, 0.f};
    int v[4] = {0, 0, 0, 0};
    if (dir == 0) {
      for (int w = 0; w < C::WARPS_N; ++w) {
        for (int q = 0; q < 2; ++q) f[q] += es.rowf[w][q][r];
        for (int q = 0; q < 4; ++q) v[q] += es.rowi[w][q][r];
      }
    } else {
      for (int w = 0; w < C::WARPS_M; ++w) {
        for (int q = 0; q < 2; ++q) f[q] += es.colf[w][q][r];
        for (int q = 0; q < 4; ++q) v[q] += es.coli[w][q][r];
      }
    }
    for (int q = 0; q < 2; ++q) fout[(dir * 2 + q) * TILE + r] = f[q];
    for (int q = 0; q < 4; ++q) iout[(dir * 4 + q) * TILE + r] = v[q];
  }
}

template <bool MISSING>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  using C = Cfg<MISSING>;
  static_assert(sizeof(EpiSmem<C::WARPS_M, C::WARPS_N>) <= C::SMEM_BYTES,
                "epilogue buffers must fit in the operand stages");
  cudaError_t err = cudaFuncSetAttribute(
      ld_sym_kernel<MISSING>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      C::SMEM_BYTES);
  if (err != cudaSuccess) return err;
  dim3 grid(p.band, p.n_tiles);
  ld_sym_kernel<MISSING><<<grid, C::THREADS, C::SMEM_BYTES, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" int ld_sym_tile() { return TILE; }

extern "C" int ld_sym_launch(const void* g, const void* m, const void* h,
                             const void* scal, const void* lo, const void* hi,
                             const void* usable, const void* dom_ok,
                             const void* poison, const void* tile_hi,
                             void* fpart, void* ipart, int n_tiles, int band,
                             int n_pad, float n, float n_padf, float adj_c,
                             float rsq_thr, int has_missing, void* stream) {
  Params p;
  p.g = static_cast<const int8_t*>(g);
  p.m = static_cast<const int8_t*>(has_missing ? m : g);   // clean: never read
  p.h = static_cast<const int8_t*>(h);
  p.scal = static_cast<const float*>(scal);
  p.lo = static_cast<const int32_t*>(lo);
  p.hi = static_cast<const int32_t*>(hi);
  p.usable = static_cast<const uint8_t*>(usable);
  p.dom_ok = static_cast<const uint8_t*>(dom_ok);
  p.poison = static_cast<const uint8_t*>(poison);
  p.tile_hi = static_cast<const int32_t*>(tile_hi);
  p.fpart = static_cast<float*>(fpart);
  p.ipart = static_cast<int32_t*>(ipart);
  p.n_tiles = n_tiles;
  p.band = band;
  p.n_pad = n_pad;
  p.n = n;
  p.n_padf = n_padf;
  p.adj_c = adj_c;
  p.rsq_thr = rsq_thr;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = has_missing ? launch<true>(p, s) : launch<false>(p, s);
  return static_cast<int>(err);
}
