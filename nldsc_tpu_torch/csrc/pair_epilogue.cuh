// Per-pair adjusted-r^2 expressions shared by the LD kernels.
//
// ld_sym.cu (the clean or global pass) and split_corr.cu (the split
// engine's delta epilogue) both turn a pair's exact integer dot products
// into its three adjusted r^2 values here.  The split engine's clean
// baseline must cancel the clean pass's value bit for bit, so both
// kernels run this one function.  Its float32 arithmetic is the one XLA
// compiles the reference's corr_from_dots into (see
// nldsc_tpu_torch/core/numerics.py): each multiply that feeds an add is
// an explicit __fmaf_rn, at the sites where the twin calls fma_rn, and
// the division by n is a product by inv_n = f32(1/n).  _build.py
// compiles every source with -fmad=false, so no other multiply and add
// are contracted.

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
  const float a1 = __fmaf_rn(-am_i, suh - sug, sgh - sgg);
  const float a2 = __fmaf_rn(-am_i, sug - 0.5f * suh, sgg - 0.5f * sgh);
  const float a0 = __fmaf_rn(-am_i, suu - 0.5f * suh, sgu - 0.5f * sgh);
  return __fmaf_rn(v2, a2, __fmaf_rn(v0, a0, v1 * a1));
}

// 1 - (1 - r^2) * adj_c (ld_int8.adj_r2)
__device__ __forceinline__ float adj_r2(float r, float adj_c) {
  return __fmaf_rn(-__fmaf_rn(-r, r, 1.0f), adj_c, 1.0f);
}

struct PairAdj {
  float add;   // adjusted r^2 of the additive pair
  float da;    // additive of i with the dominance residual of j
  float db;    // dominance residual of i with the additive of j
};

// corr_from_dots(symmetric=True) followed by adj_r2.  sgg, sgh, shg are
// the exact products; sgu, sug, suh, suu, shu the masked sums (plain
// per-SNP sums, and suu = n, when no genotype is missing); si, sj the
// NSCAL scalars of the pair's i and j; inv_n = f32(1/n).
__device__ __forceinline__ PairAdj pair_adj(float sgg, float sgh, float shg,
                                            float sgu, float sug, float suh,
                                            float suu, float shu,
                                            const float* si, const float* sj,
                                            float inv_n, float adj_c) {
  const float am_i = si[AM], am_j = sj[AM];
  const float ac = __fmaf_rn(am_i * am_j, suu,
                             __fmaf_rn(-am_j, sgu, __fmaf_rn(-am_i, sug, sgg)));
  const float r_add = ac * si[INV_SD] * sj[INV_SD] * inv_n;
  const float dom_a = dom_dot(sgg, sgh, sgu, sug, suh, suu, am_i, sj[V0],
                              sj[V1], sj[V2]);
  const float r_da = dom_a * si[INV_SD] * sj[INV_RSTD] * inv_n;
  const float dom_b = dom_dot(sgg, shg, sug, sgu, shu, suu, am_j, si[V0],
                              si[V1], si[V2]);
  const float r_db = dom_b * si[INV_RSTD] * sj[INV_SD] * inv_n;
  PairAdj out;
  out.add = adj_r2(r_add, adj_c);
  out.da = adj_r2(r_da, adj_c);
  out.db = adj_r2(r_db, adj_c);
  return out;
}

}  // namespace nldsc
