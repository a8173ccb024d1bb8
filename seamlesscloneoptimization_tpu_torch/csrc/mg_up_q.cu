// mg_up_q: the quarter-plane finest level's ascent, the row prolongation of
// the split coarse correction + the add + nu2 red-black sweeps, in one pass
// (the last ascent of a fixed-cycle solve), optionally with the max |residual|
// of the state it writes (every ascent of the check-first tolerance loop).
//
// Replaces: seamlesscloneoptimization_tpu/ops/pallas_mg_quarter.py:
// mg_up_q_pallas, with and without its with_residual option (bodies
// _up_q_body, _up_q_kernel).
//
// In: u, g (C, 4, hq, wq2) f32 quarter planes as for mg_down_q; e_even,
// e_odd (C, hq, wq2), the even / odd dense-column planes of the coarse
// correction prolonged along w (mg_prolong_tq), rows [0, hc) used and the
// rest taken as 0. Inside the domain: dense row 2q += 0.5 (E(q-1) + E(q)),
// dense row 2q+1 += E(q), with the even-h edge weights on quarter row hc
// (mg_level_q.cuh: correct); then nu2 <= 4 sweeps. Out: the swept u, exact
// zeros outside the domain; with rmax != nullptr each block also writes max
// |g - A u| over its owned tile (red cells; black ones are 0 after the black
// half-sweep) to rmax[(c * ny + by) * nx + bx], which the wrapper reduces
// with one amax. Arithmetic in the twin's order (ops/kernels.py:
// mg_up_q_plain), bit-equal to it.
//
// Bound on this card: bytes. u and g read once, the two half-width
// correction planes read once, u written once: 3 x 4 x 1408 x 1920 x 12 B +
// 2 x 3 x 1408 x 1920 x 4 B = 454 MB at the 8K level (0.14 ms at
// 3.35 TB/s); the residual adds ~10 flops per red point and no byte but the
// per-tile maxima. Design: mg_down_q's tile and staging (mg_level_q.cuh);
// the correction walks each column down, reading each row of e_even /
// e_odd once; the residual reuses the descent's (residual, store_max) on
// the swept tile, exact since the ring keeps 2 nu2 half-sweeps and the
// residual's one extra dense layer exact (nu2 <= 3 the Shallow ring,
// nu2 = 4 the Deep one).
//
// Plain C interface, loaded with ctypes; launches on the caller's stream and
// returns the launch's cudaError_t.

#include "mg_level_q.cuh"

// u, g, u_out: (c, 4, hq, wq2) f32 contiguous; e_even, e_odd: (c, hq, wq2)
// f32 contiguous; rmax: nullptr or (c * hq / 32 * wq2 / 64) f32. (h, w): the
// true dense domain; 0 <= nu2 <= 4; up_a, up_b: the even-h edge weights.
extern "C" int mg_up_q_launch(const void* u, const void* g, const void* e_even,
                              const void* e_odd, void* u_out, void* rmax, int c, int hq,
                              int wq2, int h, int w, int nu2, float up_a, float up_b,
                              void* stream) {
  return mgq::launch<true, false>(
      static_cast<const float*>(u), static_cast<const float*>(g),
      static_cast<const float*>(e_even), static_cast<const float*>(e_odd),
      static_cast<float*>(u_out), nullptr, nullptr, nullptr, static_cast<float*>(rmax), c,
      mgq::Geo{h, w, hq, wq2}, nu2, 0, 0, mgq::Weights{up_a, up_b, 0.0f, 0.0f, 0.0f, 0.0f},
      stream);
}
