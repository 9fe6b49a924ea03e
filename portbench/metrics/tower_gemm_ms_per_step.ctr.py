"""Device ms a step of the matrix-product kernels (cuBLAS's) in the traced
stretch of a CTR cell: the deep tower's products, forward and backward."""

from portbench import trace

GEMM = ("gemm", "gemv", "xmma", "nvjet", "cutlass")


def read(record, config, traffic):
    s = record.stretch
    return 1e3 * trace.seconds_of(s.events, GEMM) / s.steps
