from .ops import embedding_bag, embedding_bag_grouped  # noqa: F401
from .plain import (embedding_bag_grouped_plain,  # noqa: F401
                    embedding_bag_plain)
