"""Mean wall ms a batch of the host int8 GEMMs of the IVF member scans
(spans ``ivf_gemm``, summed over the segments)."""


def read(run):
    return run.per_batch("ivf_gemm")
