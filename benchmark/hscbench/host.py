"""What the host and the card did around a window: a fixed unit of host work
timed before and after it (the host's speed, whatever slows it), and the
card's SM clock, power, temperature and throttle reasons just after it.  A
rate that moves between runs is read beside these, so that a drift of the
card's clocks or of the host's speed shows as one.  (Steal time and the
cores' clocks are not read: the machines' `/proc` does not give them.)
"""

from __future__ import annotations

import subprocess
import time

import numpy as np


def work_ms(reps: int = 3) -> float:
    """The least time of `reps` units of fixed host work: an interpreted
    loop and a 16 MB numpy pass, the two kinds of work the host path does."""
    a = np.arange(1 << 21, dtype=np.float64)
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        s = 0
        for i in range(200_000):
            s += i & 7
        float((a * 1.0001).sum())
        best = min(best, time.perf_counter() - t0)
    return best * 1e3


def card_state() -> dict:
    """The first card's SM clock (MHz), power draw (W), temperature (C) and
    active throttle reasons, from `nvidia-smi`; empty where it cannot run."""
    keys = ("sm_mhz", "power_w", "temp_c", "throttle")
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,temperature.gpu,clocks_throttle_reasons.active",
             "--format=csv,noheader,nounits"], capture_output=True, text=True, timeout=30,
        )
        vals = [v.strip() for v in out.stdout.strip().splitlines()[0].split(",")]
    except (OSError, subprocess.SubprocessError, IndexError):
        return {}
    state = {}
    for k, v in zip(keys, vals):
        try:
            state[k] = v if k == "throttle" else float(v)
        except ValueError:
            state[k] = v
    return state


class Window:
    """Readings taken at the window's start (`Window()`) and end (`close`)."""

    def __init__(self):
        self.work_before_ms = work_ms()

    def close(self, card: bool) -> dict:
        out = {"work_before_ms": self.work_before_ms, "work_after_ms": work_ms()}
        if card:
            out.update(card_state())
        return out
