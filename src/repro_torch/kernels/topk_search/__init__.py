from .ops import topk_search, topk_search_q8  # noqa: F401
from .plain import topk_search_plain, topk_search_q8_plain  # noqa: F401
