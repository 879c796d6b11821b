"""From a torch.profiler run to spans: the device's kernels and the
benchmark's host ranges.

``device_spans``, ``union_us`` and ``attributed_us`` are copies of
``chip_smoke.py``'s: a kernel's name is its ``k_<name><template args>``
where it has one (the port's hand-written kernels), else the library's
name; where spans overlap (a kernel started by programmatic dependent
launch is resident, waiting, while the one before it runs) the union
counts each instant once, and ``attributed_us`` gives each instant to the
earliest-started kernel running then.
"""

from __future__ import annotations

import heapq
import math
import re

HOST_PREFIX = "portbench."


def kernel_name(name):
    m = re.search(r"k_\w+(<[^>]*>)?", name)
    if m:
        return m.group(0)
    return re.sub(r"^void |at::native::|\(anonymous namespace\)::", "",
                  name)[:64]


def split_events(events):
    """(device spans [(start us, end us, name)], host ranges [(name, start
    us, end us)]) of a profiler's ``events()``: every device activity
    (kernels, copies, sets) except the device-side images of the host
    ranges, and the ``portbench.*`` host ranges."""
    dev, host = [], []
    for e in events:
        name = e.name
        if name.startswith(HOST_PREFIX):
            if not str(getattr(e, "device_type", "")).endswith("CUDA"):
                host.append((name[len(HOST_PREFIX):], e.time_range.start,
                             e.time_range.end))
            continue
        if str(getattr(e, "device_type", "")).endswith("CUDA"):
            dev.append((e.time_range.start, e.time_range.end,
                        kernel_name(name)))
    return sorted(dev), sorted(host, key=lambda h: h[1])


def is_kernel(span):
    return not span[2].startswith(("Memcpy", "Memset"))


def union_us(spans):
    total, end = 0.0, -math.inf
    for start, stop, _ in sorted(spans):
        if stop > end:
            total += stop - max(start, end)
            end = stop
    return total


def attributed_us(spans):
    """{kernel name: us}: each instant given to the earliest-started kernel
    running then."""
    spans = sorted(spans)
    edges = sorted({t for a, b, _ in spans for t in (a, b)})
    out, active, i = {}, [], 0
    for t0, t1 in zip(edges, edges[1:]):
        while i < len(spans) and spans[i][0] <= t0:
            heapq.heappush(active, spans[i])
            i += 1
        while active and active[0][1] <= t0:
            heapq.heappop(active)
        if active:
            name = active[0][2]
            out[name] = out.get(name, 0.0) + (t1 - t0)
    return out


def inside(spans, ranges):
    """(spans that start inside one of ``ranges`` [(start, end)], the
    others)."""
    ranges = sorted(ranges)
    ins, outs = [], []
    for sp in spans:
        hit = any(a <= sp[0] <= b for a, b in ranges)
        (ins if hit else outs).append(sp)
    return ins, outs


def busy_intervals(spans):
    """The union of ``spans`` as sorted disjoint [start, end] intervals."""
    out = []
    for start, stop, _ in sorted(spans):
        if out and start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], stop)
        else:
            out.append([start, stop])
    return out


def idle_gaps(spans, host, t0, t1, top=10):
    """The ``top`` longest device-idle gaps within [t0, t1] (us), each
    named by the innermost host range open at its middle: [[name, us]]."""
    gaps, cur = [], t0
    for a, b in busy_intervals(spans):
        if a > cur:
            gaps.append((cur, min(a, t1)))
        cur = max(cur, b)
    if t1 > cur:
        gaps.append((cur, t1))
    out = []
    for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:top]:
        mid = 0.5 * (a + b)
        opened = [h for h in host if h[1] <= mid <= h[2]]
        name = (min(opened, key=lambda h: h[2] - h[1])[0] if opened
                else "between rounds")
        out.append([name, b - a])
    return out


def top_ops(spans, top=10):
    """[[kernel name, us]] of the ``top`` device ops by total time."""
    tot = {}
    for a, b, name in spans:
        tot[name] = tot.get(name, 0.0) + (b - a)
    return [[k, v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])
            [:top]]
