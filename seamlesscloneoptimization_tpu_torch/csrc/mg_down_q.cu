// mg_down_q: the quarter-plane finest level's descent, nu1 red-black sweeps +
// the red-cell residual + its row restriction, and either the transposed x4
// lane restriction into the coarse level's RHS (the fused form) or the row
// restriction's even / odd column planes (the split form), in one pass.
//
// Replaces: seamlesscloneoptimization_tpu/ops/pallas_mg_quarter.py:
// mg_down_q_pallas in both forms (rct_rows given: bodies _down_q_body,
// _rct_strip; rct_rows=None: _down_q_body's rh_e, rh_o; _down_q_kernel, and
// _down_q_kernel0 for the known-zero guess).
//
// In: g, u (C, 4, hq, wq2) f32 quarter planes (mg_level_q.cuh), exact zeros
// outside the true (h, w) domain; u == nullptr is a known-zero guess (the
// first descent of a zero-start solve), synthesized instead of read, whose
// first red half-sweep is (0 - g) * 0.25. Out: the swept u and, fused, rc_t
// (C, chp, hq), the RHS of the (wc, hc) coarse level in transposed
// orientation: rc_t[jw, jc] = 4 x the full-weighting restriction of the
// residual, every element written (zeros for jw >= wc or jc >= hc); split,
// rh_e and rh_o (C, hq, wq2), the row-restricted residual's even / odd dense
// columns, rows [0, hc) data, exact zeros beyond (mg_restrict_tq takes them).
// Arithmetic in the twin's order (ops/kernels.py: mg_down_q_plain), bit-equal
// to it; split + mg_restrict_tq is bit-equal to the fused form.
//
// Bound on this card: bytes. g and u read once, u and rc_t written once:
// 3 x 4 x 1408 x 1920 x 12 B + 3 x 1920 x 1408 x 4 B = 422 MB at the 8K
// level (3, 4, 1408, 1920) (0.13 ms at 3.35 TB/s), 292 MB with the
// known-zero guess; the split form writes 2 x 3 x 1408 x 1920 x 4 B of rh
// instead of rc_t: 454 MB (0.136 ms), 324 MB with the known-zero guess;
// ~12 flops per dense point and sweep. Design (mg_level_q.cuh, shared
// with mg_ud_q): one block of 256 threads per (channel, 32 x 64 quarter
// tile = 64 x 128 dense points); the four planes of u and g are staged with
// asynchronous 16-byte copies and a ring as deep as the 2 nu1 half-sweeps
// need (Shallow: 4 / 5 rows, 4 / 8 columns, 99.7 KB, two blocks an SM);
// each half-sweep updates its colour's two planes over a region that
// shrinks by one dense layer a half-sweep; the residual lands in two of g's
// planes, and the block writes its u tile and its 64 x 32 block of rc_t (or
// of rh_e and rh_o).
//
// Plain C interface, loaded with ctypes; launches on the caller's stream and
// returns the launch's cudaError_t.

#include "mg_level_q.cuh"

// u (nullable: known-zero guess), g, u_out: (c, 4, hq, wq2) f32 contiguous,
// hq % 32 == 0, wq2 % 64 == 0. Fused form: rc_t (c, chp, hq) f32 contiguous,
// wc <= chp <= wq2, rh_e = rh_o = nullptr. Split form: rc_t == nullptr, rh_e,
// rh_o (c, hq, wq2) f32 contiguous. (h, w): the true dense domain; 1 <= nu1
// <= 2; dn_e, dn_o, rc_a, rc_b: the even-h / even-w edge weights
// (mg_level_q.cuh: Weights).
extern "C" int mg_down_q_launch(const void* u, const void* g, void* u_out, void* rc_t,
                                void* rh_e, void* rh_o, int c, int hq, int wq2, int chp,
                                int h, int w, int nu1, float dn_e, float dn_o, float rc_a,
                                float rc_b, void* stream) {
  const mgq::Geo G{h, w, hq, wq2};
  const mgq::Weights W{0.0f, 0.0f, dn_e, dn_o, rc_a, rc_b};
  const float* uf = static_cast<const float*>(u);
  const float* gf = static_cast<const float*>(g);
  float* of = static_cast<float*>(u_out);
  if (rc_t == nullptr)
    return mgq::launch<false, true, true>(uf, gf, nullptr, nullptr, of, nullptr,
                                          static_cast<float*>(rh_e),
                                          static_cast<float*>(rh_o), nullptr, c, G, 0, nu1,
                                          0, W, stream);
  return mgq::launch<false, true>(uf, gf, nullptr, nullptr, of, static_cast<float*>(rc_t),
                                  nullptr, nullptr, nullptr, c, G, 0, nu1, chp, W, stream);
}
