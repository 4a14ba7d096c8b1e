// Per-pair adjusted-r^2 expressions shared by the LD kernels.
//
// ld_sym.cu (the clean or global pass) and split_corr.cu (the split
// engine's delta epilogue) both turn a pair's exact integer dot products
// into its three adjusted r^2 values here.  The split engine's clean
// baseline must cancel the clean pass's value bit for bit, so both
// kernels run this one function, and _build.py compiles every source
// with -fmad=false: each float32 operation rounds on its own, in the
// order of corr_from_dots (nldsc_tpu_torch/ld/ld_int8.py).

#pragma once

namespace nldsc {

constexpr int NSCAL = 9;
// per-SNP scalar fields, in ld_int8.SCAL_FIELDS order
enum { AM, INV_SD, INV_RSTD, V0, V1, V2, GSUM, HSUM, CMISS };

// dot(a_c_i, r_j) over the genotype classes of j (ld_int8._dom_dot)
__device__ __forceinline__ float dom_dot(float sgg, float sgh, float sgu,
                                         float sug, float suh, float suu,
                                         float am_i, float v0, float v1,
                                         float v2) {
  float a1 = (sgh - sgg) - am_i * (suh - sug);
  float a2 = (sgg - 0.5f * sgh) - am_i * (sug - 0.5f * suh);
  float a0 = (sgu - 0.5f * sgh) - am_i * (suu - 0.5f * suh);
  return v0 * a0 + v1 * a1 + v2 * a2;
}

struct PairAdj {
  float add;   // adjusted r^2 of the additive pair
  float da;    // additive of i with the dominance residual of j
  float db;    // dominance residual of i with the additive of j
};

// corr_from_dots(symmetric=True) followed by 1 - (1 - r^2) * adj_c.
// sgg, sgh, shg are the exact products; sgu, sug, suh, suu, shu the
// masked sums (plain per-SNP sums when no genotype is missing); si, sj
// the NSCAL scalars of the pair's i and j.
__device__ __forceinline__ PairAdj pair_adj(float sgg, float sgh, float shg,
                                            float sgu, float sug, float suh,
                                            float suu, float shu,
                                            const float* si, const float* sj,
                                            float n, float adj_c) {
  const float am_i = si[AM], am_j = sj[AM];
  const float ac = sgg - am_i * sug - am_j * sgu + am_i * am_j * suu;
  const float r_add = ac * si[INV_SD] * sj[INV_SD] / n;
  const float dom_a = dom_dot(sgg, sgh, sgu, sug, suh, suu, am_i, sj[V0],
                              sj[V1], sj[V2]);
  const float r_da = dom_a * si[INV_SD] * sj[INV_RSTD] / n;
  const float dom_b = dom_dot(sgg, shg, sug, sgu, shu, suu, am_j, si[V0],
                              si[V1], si[V2]);
  const float r_db = dom_b * si[INV_RSTD] * sj[INV_SD] / n;
  PairAdj out;
  out.add = 1.0f - (1.0f - r_add * r_add) * adj_c;
  out.da = 1.0f - (1.0f - r_da * r_da) * adj_c;
  out.db = 1.0f - (1.0f - r_db * r_db) * adj_c;
  return out;
}

}  // namespace nldsc
