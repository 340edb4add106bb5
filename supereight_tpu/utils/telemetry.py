"""Device telemetry sampling.

Behavioral reference: the ODROID PowerMonitor
(se_apps/src/PowerMonitor.cpp:14-56) — periodic hardware counters fed
into PerfStats. The analogues available in-process are the device
memory statistics and allocation watermarks.
"""

import jax

from supereight_tpu.utils.perfstats import PerfStats, StatType


class DeviceMonitor:
    """Samples per-device memory stats into a PerfStats instance."""

    def __init__(self, stats: PerfStats = None):
        self.stats = stats or PerfStats()

    def sample(self):
        for i, dev in enumerate(jax.local_devices()):
            try:
                ms = dev.memory_stats()
            except Exception:
                continue
            if not ms:
                continue
            for key in ("bytes_in_use", "peak_bytes_in_use",
                        "bytes_limit"):
                if key in ms:
                    self.stats.sample(f"dev{i}.{key}", ms[key],
                                      StatType.UNDEFINED)
        return self.stats
