"""The yardstick: an H100's peaks, the work an RMQ must move, and the
device's busy time, frozen here so that no change to the program moves them.

- The peak of one NVIDIA H100 SXM (NVIDIA's data sheet, at its 700 W
  limit), the figure of ``repro_torch.launch.roofline.HW``: 3.35 TB/s of
  HBM3. A share is stated against it, with the card's power limit beside it.
- The work of a query is 16 bytes whatever answers it: its two int32
  bounds read, its int32 index and 32-bit value written. That is the least
  any exact method moves (a table, a scan, a ray tracer); the array's bytes
  depend on the structure, so they are not counted. A share of it can
  never pass 100%.
- Busy time is the union of the device's operation intervals in a traced
  window (``repro_torch``'s ``chip_smoke._device_busy_share`` summed their
  device times; a union cannot count two overlapping operations twice).
"""

from __future__ import annotations

__all__ = [
    "BYTES_PER_QUERY",
    "CSRC_KERNELS",
    "CSRC_QUERY_KERNELS",
    "HBM_BYTES_PER_S",
    "busy_seconds",
    "idle_gaps",
    "is_copy",
    "is_csrc",
    "is_csrc_query",
    "is_memset",
    "merge",
    "query_bytes",
    "roofline_pct",
]

HBM_BYTES_PER_S = 3.35e12
BYTES_PER_QUERY = 16  # 2 x int32 bounds in, int32 index + 32-bit value out

# Name stems of the port's hand-written kernels (``repro_torch/csrc``) that
# the cells run: the short path's query kernel, and with the build's.
CSRC_QUERY_KERNELS = ("fused_query",)
CSRC_KERNELS = CSRC_QUERY_KERNELS + ("block_min",)


def query_bytes(queries: int) -> int:
    """The bytes ``queries`` exact range minima must move, whatever the method."""
    return BYTES_PER_QUERY * int(queries)


def roofline_pct(queries: int, device_s: float):
    """The share (%) of the HBM roofline: the least time the queries' bytes
    take at 3.35 TB/s over the device time spent on them; None where there
    is nothing to read."""
    if queries <= 0 or device_s <= 0:
        return None
    return 100.0 * query_bytes(queries) / HBM_BYTES_PER_S / device_s


def is_copy(name: str) -> bool:
    return name.startswith("Memcpy")


def is_memset(name: str) -> bool:
    return name.startswith("Memset")


def is_csrc_query(name: str) -> bool:
    return any(stem in name for stem in CSRC_QUERY_KERNELS)


def is_csrc(name: str) -> bool:
    return any(stem in name for stem in CSRC_KERNELS)


def merge(intervals) -> list:
    """The union of ``(start, end)`` intervals as sorted disjoint intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [tuple(iv) for iv in out]


def busy_seconds(device_events, lo_us: float, hi_us: float) -> float:
    """Seconds of ``[lo_us, hi_us]`` in which some device operation ran;
    ``device_events`` are ``(name, start_us, end_us)``."""
    clipped = [(max(s, lo_us), min(e, hi_us)) for _, s, e in device_events]
    return sum(e - s for s, e in merge(iv for iv in clipped if iv[1] > iv[0])) / 1e6


def idle_gaps(device_events, host_events, lo_us: float, hi_us: float, top: int = 10) -> list:
    """The device's idle time in ``[lo_us, hi_us]`` by what the host was
    doing: each gap between device operations is named after the innermost
    host event over its middle, and the gaps are summed by name.
    ``[[name, seconds], ...]``, the largest ``top``."""
    busy = merge((max(s, lo_us), min(e, hi_us)) for _, s, e in device_events if e > lo_us and s < hi_us)
    gaps, t = [], lo_us
    for s, e in busy:
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if hi_us > t:
        gaps.append((t, hi_us))
    by_name = {}
    for s, e in gaps:
        mid = (s + e) / 2
        over = [(he - hs, name) for name, hs, he in host_events if hs <= mid <= he]
        name = min(over)[1] if over else "(no host event)"
        by_name[name] = by_name.get(name, 0.0) + (e - s) / 1e6
    return [[k, v] for k, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:top]]
