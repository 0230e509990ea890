"""Mean wall ms a batch of the exact fp32 rescores of quantized pools
(spans ``rescore`` in ``index/quant.rescore_topk``, summed: the fused
block's and each IVF segment's)."""


def read(run):
    return run.per_batch("rescore")
