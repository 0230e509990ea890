from .ops import gather_segment_sum, segment_sum  # noqa: F401
from .plain import (EdgePlan, gather_segment_sum_plain,  # noqa: F401
                    segment_sum_plain, take_rows, weight_grad)
