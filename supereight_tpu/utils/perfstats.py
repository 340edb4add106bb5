"""Performance statistics collection.

Behavioral reference: se_shared/perfstats.h (insertion-ordered named
series with type tags and mean/min/max/sum summaries) and the TICK/TOCK
kernel timing macros (se_shared/timings.h:7-15). The device analogue of a
kernel timer is a context manager that blocks on device results before
reading the clock; jax.profiler traces cover the deeper view.
"""

import contextlib
import os
import time
from collections import OrderedDict
from enum import Enum

import jax


class StatType(Enum):
    TIME = "time"
    COUNT = "count"
    FRAME = "frame"
    DISTANCE = "distance"
    POWER = "power"
    ENERGY = "energy"
    UNDEFINED = "undefined"


class PerfStats:
    """Insertion-ordered named sample series (ref perfstats.h:32-130)."""

    def __init__(self):
        self.series = OrderedDict()
        self.types = {}

    def sample(self, key, value, kind=StatType.UNDEFINED):
        self.series.setdefault(key, []).append(float(value))
        self.types.setdefault(key, kind)

    def has(self, key):
        return key in self.series

    def last(self, key):
        return self.series[key][-1]

    def mean(self, key):
        s = self.series[key]
        return sum(s) / len(s)

    def min(self, key):
        return min(self.series[key])

    def max(self, key):
        return max(self.series[key])

    def sum(self, key):
        return sum(self.series[key])

    def reset(self, key=None):
        if key is None:
            self.series.clear()
            self.types.clear()
        else:
            self.series.pop(key, None)

    def print_summary(self, out=None):
        import sys
        out = out or sys.stdout
        for key in self.series:
            out.write(f"{key}\tmin={self.min(key):.6f}\t"
                      f"max={self.max(key):.6f}\tmean={self.mean(key):.6f}\t"
                      f"sum={self.sum(key):.6f}\n")

    @contextlib.contextmanager
    def timer(self, key, sync=None):
        """TICK/TOCK equivalent (ref timings.h:7-15). ``sync``: a JAX array
        (or pytree) to block_until_ready before stopping the clock, so
        device time is attributed to the right stage."""
        t0 = time.perf_counter()
        box = {}
        yield box
        if "sync" in box:
            jax.block_until_ready(box["sync"])
        elif sync is not None:
            jax.block_until_ready(sync)
        self.sample(key, time.perf_counter() - t0, StatType.TIME)


# global instance like the reference's `PerfStats Stats` (timings.h)
Stats = PerfStats()
KERNEL_TIMINGS = bool(os.environ.get("KERNEL_TIMINGS"))
