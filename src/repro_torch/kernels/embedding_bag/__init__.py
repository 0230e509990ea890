from .ops import embedding_bag  # noqa: F401
from .plain import embedding_bag_plain  # noqa: F401
