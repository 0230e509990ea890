from .ops import flash_attention  # noqa: F401
from .plain import flash_attention_plain  # noqa: F401
