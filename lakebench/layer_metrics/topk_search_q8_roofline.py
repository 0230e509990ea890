"""Share of its roofline that the ``topk_search_q8`` kernel (the hot
tier's fused int8 block) reached over the traced window
(``counts/topk_search_q8.py``)."""
from lakebench.roofline import share


def read(run):
    return share(run, "topk_search_q8")
