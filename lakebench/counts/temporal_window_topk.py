"""Work of one fp32 ``temporal_window_topk`` call, from its shapes: the
N history rows (D fp32 each) and their two int64 validity columns read
once, the Q real queries read once, the (Q, k) scores and ids written
once, and 2 Q N D operations."""

SPAN = "kernel:temporal_window_topk"
PEAK = "fp32"


def matches(kernel: str) -> bool:
    return "WindowMask" in kernel and "signed char" not in kernel \
        and "int8" not in kernel


def work(call: dict) -> tuple[float, float]:
    n, q, d, k = call["rows"], call["queries"], call["dim"], call["k"]
    return (n * d * 4 + n * 16 + q * d * 4 + q * k * 8,
            2.0 * q * n * d)
