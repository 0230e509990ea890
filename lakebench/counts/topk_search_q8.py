"""Work of one ``topk_search_q8`` call (the hot tier's fused int8 block),
from its shapes: the N rows (D int8 each) and their bool mask read once,
the Q real queries (fp32) read once, the (Q, k') pool of scores and ids
written once, and 2 Q N D operations."""

SPAN = "kernel:topk_search_q8"
PEAK = "int8"


def matches(kernel: str) -> bool:
    return "BoolMask" in kernel and ("signed char" in kernel
                                     or "int8" in kernel)


def work(call: dict) -> tuple[float, float]:
    n, q, d, k = call["rows"], call["queries"], call["dim"], call["pool"]
    return (n * d + n + q * d * 4 + q * k * 8, 2.0 * q * n * d)
