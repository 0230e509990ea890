from .ops import (gather_segment_sum, segment_sum,  # noqa: F401
                  segment_sum_bwd, take)
from .plain import (EdgePlan, gather_segment_sum_plain,  # noqa: F401
                    segment_sum_bwd_plain, segment_sum_plain, take_rows,
                    weight_grad)
