"""Reading the traced part of a window from `torch.profiler`'s chrome trace.

The arithmetic is `chip_smoke.device_profile`'s: a card's busy time is the
union of its kernel, copy and fill intervals; a kernel's device time is the
sum of its events' durations.  Beside it: the idle gaps between the busy
intervals, each named by the benchmark span and the host-side torch
operation it fell in.  The trace is written under the run's temporary
directory, read once and deleted.
"""

from __future__ import annotations

import bisect
import json
import os

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def merged(spans) -> list[tuple[float, float]]:
    """The union of (start, end) intervals as disjoint intervals, in order."""
    out: list[list[float]] = []
    for lo, hi in sorted(spans):
        if out and lo <= out[-1][1]:
            out[-1][1] = max(out[-1][1], hi)
        else:
            out.append([lo, hi])
    return [(a, b) for a, b in out]


def union(spans) -> float:
    """Length of the union of (start, end) intervals, in their unit."""
    return sum(hi - lo for lo, hi in merged(spans))


def short_name(name: str) -> str:
    return name.replace("(anonymous namespace)::", "").split("(")[0].split("<")[0].replace("void ", "")[-60:]


class Trace:
    """The device side of one traced stretch of a window."""

    def __init__(self, events: list[dict], window_us: tuple[float, float]):
        self.t0, self.t1 = window_us
        self.device_events = [
            e for e in events
            if e.get("cat") in DEVICE_CATS and "dur" in e and self.t0 <= float(e["ts"]) <= self.t1
        ]
        self.host_ops = [e for e in events if e.get("cat") in ("cpu_op", "user_annotation") and "dur" in e]

    @classmethod
    def from_profiler(cls, prof, path: str, span: str = "bench:traced") -> "Trace":
        """The trace of `prof`, cut to the benchmark's span `span`."""
        prof.export_chrome_trace(path)
        try:
            with open(path) as f:
                events = json.load(f).get("traceEvents", [])
        finally:
            os.remove(path)
        marks = [e for e in events if e.get("cat") == "user_annotation" and e.get("name") == span]
        if not marks:
            raise RuntimeError(f"the trace holds no {span!r} span")
        t0 = float(marks[0]["ts"])
        return cls(events, (t0, t0 + float(marks[0]["dur"])))

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e6

    def cards(self) -> dict[int, list[tuple[float, float]]]:
        by: dict[int, list] = {}
        for e in self.device_events:
            card = int(e.get("args", {}).get("device", e.get("pid", -1)))
            ts = float(e["ts"])
            by.setdefault(card, []).append((ts, min(ts + float(e["dur"]), self.t1)))
        return by

    def busy_s(self, card: int | None = None) -> float:
        cards = self.cards()
        if card is not None:
            return union(cards.get(card, [])) / 1e6
        return union([s for v in cards.values() for s in v]) / 1e6

    def kernel_s(self, *needles: str) -> tuple[float, int]:
        """Device seconds and launches of the kernels whose name holds one
        of `needles`."""
        total, n = 0.0, 0
        for e in self.device_events:
            if e["cat"] == "kernel" and any(s in e["name"] for s in needles):
                total += float(e["dur"]) / 1e6
                n += 1
        return total, n

    def top_ops(self, n: int = 10) -> list[list]:
        by: dict[str, float] = {}
        for e in self.device_events:
            key = short_name(e["name"]) if e["cat"] == "kernel" else e["cat"] + ":" + e["name"][-40:]
            by[key] = by.get(key, 0.0) + float(e["dur"]) / 1e6
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> list[list]:
        """Idle seconds of the cards (no card busy), grouped by what the
        host was doing: the innermost benchmark span and the torch
        operation covering most of the gap, if any."""
        busy = merged([s for v in self.cards().values() for s in v])
        gaps, prev = [], self.t0
        for lo, hi in busy:
            if lo > prev:
                gaps.append((prev, lo))
            prev = max(prev, hi)
        if self.t1 > prev:
            gaps.append((prev, self.t1))
        bench = sorted(
            (float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
            for e in self.host_ops
            if e["cat"] == "user_annotation" and e["name"].startswith("bench:") and e["name"] != "bench:traced"
        )
        ops = sorted(
            (float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
            for e in self.host_ops if e["cat"] == "cpu_op"
        )
        bench_lo = [s[0] for s in bench]
        ops_lo = [s[0] for s in ops]
        by: dict[str, float] = {}
        for lo, hi in gaps:
            mid = (lo + hi) / 2
            name, op = "outside any span", "no torch op"
            i = bisect.bisect_right(bench_lo, mid)
            for b_lo, b_hi, b_name in reversed(bench[max(0, i - 8):i]):
                if b_hi >= mid:
                    name = b_name
                    break
            # the innermost torch op over the gap's middle that covers most of it
            j = bisect.bisect_right(ops_lo, mid) - 1
            for s_lo, s_hi, op_name in reversed(ops[max(0, j - 64):j + 1]):
                if s_hi >= mid and min(hi, s_hi) - max(lo, s_lo) > 0.5 * (hi - lo):
                    op = op_name
                    break
            key = f"{name} / {op}"
            by[key] = by.get(key, 0.0) + (hi - lo) / 1e6
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]
