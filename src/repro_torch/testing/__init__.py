"""Test/chaos support utilities shipped with the library.

``repro_torch.testing.faults`` is imported by production modules (the fault
check is a no-op two-instruction fast path when nothing is armed), so
this package must stay dependency-free and cheap to import.
"""
from .equivalence import (grads_agree, lse_agree, partials_agree,
                          results_equivalent, rounding_agree, topk_agree)
from .faults import FAULTS, FaultError, FaultRegistry, FaultRule

__all__ = ["FAULTS", "FaultError", "FaultRegistry", "FaultRule",
           "grads_agree", "lse_agree", "partials_agree", "results_equivalent",
           "rounding_agree", "topk_agree"]
