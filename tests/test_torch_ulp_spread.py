"""How far a one-ulp change of the RHS moves the tolerance-mode quarter-plane
solve, in the JAX package (interpreted) and in the port, on the CPU.

The port's tolerance-mode ``solve_multigrid(padded="q")`` is held to JAX's
at rel 5e-5 (``tests/test_torch_quarter_dense.py``), not the 1e-5 of the
other solves. This measures the reason given for that bar: the spread of
either implementation's result under a one-ulp change of g, beside the
distance between the two. It holds no test (the tier-1 suite stays
unchanged by it); run it by hand:

    python tests/test_torch_ulp_spread.py

It prints one line per (shape, flipped element): the cycles, JAX's and the
port's relative change max |u(g') - u(g)| / max |u(g)|, and the relative
distance between the two implementations on g.
"""

import os
import sys

import numpy as np

SHAPES = [(1, 512, 520), (3, 511, 517)]  # the dense-solve tests' shapes and RHS seed


def _rel(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max() / np.abs(np.asarray(b)).max())


def main() -> int:
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import torch

    from seamlesscloneoptimization_tpu.solvers import multigrid as JM
    from seamlesscloneoptimization_tpu_torch.solvers import multigrid as TM

    def solve_jax(g):
        u, info = JM.solve_multigrid(jnp.asarray(g), padded="q", use_pallas=True,
                                     interpret=True, tol=1e-4, return_info=True)
        return np.asarray(u), int(info["cycles"])

    def solve_port(g):
        u, info = TM.solve_multigrid(torch.from_numpy(g), padded="q", use_pallas=True,
                                     tol=1e-4, return_info=True)
        return u.numpy(), info["cycles"]

    for shape in SHAPES:
        g = np.random.default_rng(16).normal(size=shape).astype(np.float32) * 50.0
        uj, cj = solve_jax(g)
        ut, ct = solve_port(g)
        print(f"{shape}: cycles JAX {cj}, port {ct}; port vs JAX rel {_rel(ut, uj):.3e}",
              flush=True)
        _, h, w = shape
        for where in ((0, h // 2, w // 2), (0, 7, 11), np.unravel_index(np.abs(g).argmax(),
                                                                          shape)):
            g1 = g.copy()
            g1[tuple(where)] = np.nextafter(g1[tuple(where)], np.float32(np.inf))
            uj1, cj1 = solve_jax(g1)
            ut1, ct1 = solve_port(g1)
            print(f"{shape} one ulp up at {tuple(int(x) for x in where)}: cycles JAX {cj1}, "
                  f"port {ct1}; JAX moves rel {_rel(uj1, uj):.3e}, port moves rel "
                  f"{_rel(ut1, ut):.3e}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
