from .ops import temporal_topk, temporal_window_topk  # noqa: F401
from .plain import temporal_window_topk_plain  # noqa: F401
