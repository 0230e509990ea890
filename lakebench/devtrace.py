"""What the profiler saw on the device: every kernel, copy and set in the
traced window, the busy time as the union of their intervals, and the
idle gaps between them."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class DeviceOp:
    name: str
    start_us: float
    end_us: float


def device_ops(prof) -> list[DeviceOp]:
    """Device-side activities of a finished ``torch.profiler.profile``,
    read from its raw results (building the profiler's event tree for
    every host op of a long window takes minutes)."""
    from torch.autograd import DeviceType

    ops = []
    raw = getattr(getattr(prof, "profiler", None), "kineto_results", None)
    if raw is not None:
        for e in raw.events():
            if e.device_type() == DeviceType.CUDA:
                ops.append(DeviceOp(e.name(), e.start_ns() / 1e3,
                                    (e.start_ns() + e.duration_ns()) / 1e3))
    else:
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                tr = e.time_range
                ops.append(DeviceOp(e.name, float(tr.start), float(tr.end)))
    ops.sort(key=lambda o: o.start_us)
    return ops


def busy_intervals(ops: list[DeviceOp]) -> list[list]:
    """Merged [start, end, first op, last op] intervals of device work."""
    out: list[list] = []
    for o in ops:
        if out and o.start_us <= out[-1][1]:
            if o.end_us > out[-1][1]:
                out[-1][1] = o.end_us
                out[-1][3] = o.name
        else:
            out.append([o.start_us, o.end_us, o.name, o.name])
    return out


def short(name: str, n: int = 48) -> str:
    base = name.split("(")[0]
    return base if len(base) <= n else base[:n]


def summary(ops: list[DeviceOp], top: int = 10) -> dict:
    """busy seconds, the device ops that took most time, and the longest
    idle gaps by the ops on either side of them (seconds, summed by that
    label)."""
    iv = busy_intervals(ops)
    busy = sum(e - s for s, e, _, _ in iv) / 1e6
    by_op: dict[str, float] = {}
    for o in ops:
        by_op[short(o.name)] = by_op.get(short(o.name), 0.0) \
            + (o.end_us - o.start_us) / 1e6
    gaps: dict[str, float] = {}
    for a, b in zip(iv, iv[1:]):
        label = f"idle after {short(a[3], 28)} before {short(b[2], 28)}"
        gaps[label] = gaps.get(label, 0.0) + (b[0] - a[1]) / 1e6
    rank = lambda d: sorted(([k, v] for k, v in d.items()),
                            key=lambda kv: -kv[1])[:top]
    return {"busy_s": busy, "device_ops": rank(by_op),
            "idle_gaps": rank(gaps)}
