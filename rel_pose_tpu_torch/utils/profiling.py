"""Throughput counters of the training loop.

``StepTimer`` is the counterpart of ``rel_pose_tpu/utils/profiling.py:16-60``
without the MFU meter: host-clock step time and pairs/s per GPU, the first
``warmup`` steps skipped.  A data-parallel run passes the global batch as
``pairs_per_step`` and its world size as ``num_chips``, as ``train.py:198``
passes the mesh's size.  The training CLI ticks it once a step after
queueing the step on the card; over many steps the queue reaches a steady
state and the mean is the device's rate, or the host's where the host is
slower.
"""

import time


class StepTimer:
    """Mean step time and throughput after ``warmup`` steps."""

    def __init__(self, pairs_per_step, num_chips=1, warmup=5):
        self.pairs_per_step = pairs_per_step
        self.num_chips = max(1, num_chips)
        self.warmup = warmup
        self.count = 0
        self._t0 = None
        self.total_time = 0.0
        self.timed_steps = 0

    def tick(self):
        """Count one step; returns its host-clock seconds, or None during
        the warm-up."""
        now = time.perf_counter()
        self.count += 1
        if self.count <= self.warmup:
            self._t0 = now
            return None
        dt = now - self._t0
        self._t0 = now
        self.total_time += dt
        self.timed_steps += 1
        return dt

    @property
    def steps_per_sec(self):
        if self.timed_steps == 0 or self.total_time == 0:
            return 0.0
        return self.timed_steps / self.total_time

    @property
    def pairs_per_sec_per_chip(self):
        return self.steps_per_sec * self.pairs_per_step / self.num_chips
