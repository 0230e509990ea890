"""Share of its roofline that the fp32 ``temporal_window_topk`` kernel
(the temporal engine's fused scan of the resident history) reached over
the traced window (``counts/temporal_window_topk.py``)."""
from lakebench.roofline import share


def read(run):
    return share(run, "temporal_window_topk")
