"""cuBLAS GEMM kernels' share of the device's busy time, in %: the DST
solve's GEMMs, or the multigrid's coarsest-level solves."""


def read(s):
    if s["busy_us"] <= 0:
        return None
    return 100.0 * s["gemm_us"] / s["busy_us"]
