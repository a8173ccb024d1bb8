// mg_ud_q: one V-cycle boundary of the quarter-plane finest level in one
// pass: the ascent of cycle k (correction + nu2 sweeps) and the descent of
// cycle k+1 (nu1 sweeps + red-cell residual + row and transposed lane
// restriction), optionally with the max |residual| of the state it writes.
//
// Replaces: seamlesscloneoptimization_tpu/ops/pallas_mg_quarter.py:
// mg_ud_q_pallas, the fused-restrict form (rct_rows; body _ud_q_kernel).
//
// In and out: mg_up_q's inputs and mg_down_q's outputs (mg_level_q.cuh).
// The post-ascent state never leaves shared memory: the descent continues on
// the staged tile, whose ring keeps the owned tile, the residual's extra row
// and column and the restriction's reads exact for 2 (nu1 + nu2) half-sweeps
// (mg_level_q.cuh: Ring::kDepth; the Shallow ring for nu1 + nu2 <= 3, the
// default 1 + 2). With rmax != nullptr each block also
// writes max |r| over its owned tile (red cells; black ones are 0 after the
// black half-sweep) to rmax[(c * ny + by) * nx + bx]; the wrapper reduces
// them with one amax, so a tolerance check costs no extra pass over u.
// Arithmetic in the twin's order (ops/kernels.py: mg_ud_q_plain), bit-equal
// to it.
//
// Bound on this card: bytes. u, g and the two correction planes read once,
// u and rc_t written once: 3 x 4 x 1408 x 1920 x 12 B + 2 x 3 x 1408 x 1920
// x 4 B + 3 x 1920 x 1408 x 4 B = 487 MB at the 8K level (0.145 ms at
// 3.35 TB/s). It replaces an mg_up_q + mg_down_q pair (908 MB) and, in
// tolerance mode, the residual pass of a check. The first design (a
// 32 x 32 tile, 8-deep ring) took 0.71 ms: staging with synchronous loads
// 0.35, the correction 0.08, the sweeps 0.22, the residual and rc_t 0.05
// (PERF.md section 6). This one takes 0.33, its staging and store 0.16 of
// it. Design (mg_level_q.cuh): asynchronous 16-byte staging on two
// resident blocks an SM, a ring only as deep as the 6 half-sweeps need
// (1.52x the owned points), a correction that reads each row of e once,
// and half-sweeps over a region that shrinks by one dense layer each.
//
// Plain C interface, loaded with ctypes; launches on the caller's stream and
// returns the launch's cudaError_t.

#include "mg_level_q.cuh"

// u, g, u_out: (c, 4, hq, wq2) f32 contiguous; e_even, e_odd: (c, hq, wq2);
// rc_t: (c, chp, hq); rmax: nullptr or (c * hq / 32 * wq2 / 64) f32. (h, w):
// the true dense domain; 0 <= nu2, 1 <= nu1, nu1 + nu2 <= 6; the six edge
// weights as in mg_level_q.cuh: Weights.
extern "C" int mg_ud_q_launch(const void* u, const void* g, const void* e_even,
                              const void* e_odd, void* u_out, void* rc_t, void* rmax,
                              int c, int hq, int wq2, int chp, int h, int w, int nu2,
                              int nu1, float up_a, float up_b, float dn_e, float dn_o,
                              float rc_a, float rc_b, void* stream) {
  return mgq::launch<true, true>(
      static_cast<const float*>(u), static_cast<const float*>(g),
      static_cast<const float*>(e_even), static_cast<const float*>(e_odd),
      static_cast<float*>(u_out), static_cast<float*>(rc_t), nullptr, nullptr,
      static_cast<float*>(rmax), c, mgq::Geo{h, w, hq, wq2}, nu2, nu1, chp,
      mgq::Weights{up_a, up_b, dn_e, dn_o, rc_a, rc_b}, stream);
}
