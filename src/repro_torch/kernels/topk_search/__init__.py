from .ops import topk_search  # noqa: F401
from .plain import topk_search_plain  # noqa: F401
