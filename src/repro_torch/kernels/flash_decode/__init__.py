from .ops import flash_decode, flash_decode_partials  # noqa: F401
from .plain import (flash_decode_partials_plain,  # noqa: F401
                    flash_decode_plain, merge_partials)
