"""Training logger: running means, console, JSONL, optional TensorBoard.

Counterpart of ``rel_pose_tpu/train/logger.py`` (the reference's
``src/logger.py``): it accumulates metrics and every ``sum_freq`` (100)
steps prints ``[step, lr] metric values`` and writes the means.
``output/<name>/runs/metrics.jsonl`` is always written; TensorBoard only
where ``torch.utils.tensorboard`` imports.  The lr is the scheduler's
current one (``get_last_lr``, the OneCycle schedule's), 0 without one.
"""

import json
import os
import time

SUM_FREQ = 100


class Logger:
    def __init__(self, name, scheduler=None, output_dir="output",
                 sum_freq=SUM_FREQ):
        self.name = name
        self.scheduler = scheduler
        self.sum_freq = sum_freq
        self.total_steps = 0
        self.running = {}
        self._writer = None
        self._jsonl = None
        self.run_dir = os.path.join(output_dir, name, "runs")
        self._t0 = time.time()
        self._last_flush_step = 0

    def _ensure_sinks(self):
        os.makedirs(self.run_dir, exist_ok=True)
        if self._jsonl is None:
            self._jsonl = open(os.path.join(self.run_dir, "metrics.jsonl"),
                               "a")
        if self._writer is None:
            try:
                from torch.utils.tensorboard import SummaryWriter
                self._writer = SummaryWriter(self.run_dir)
            except ImportError:
                self._writer = False

    def _lr(self):
        if self.scheduler is None:
            return 0.0
        return float(self.scheduler.get_last_lr()[0])

    def _flush(self, count=None):
        self._ensure_sinks()
        lr = self._lr()
        count = count or self.sum_freq
        means = {k: v / count for k, v in self.running.items()}
        steps_done = self.total_steps + 1 - self._last_flush_step
        dt = time.time() - self._t0
        rate = steps_done / dt if dt > 0 else 0.0
        metrics_str = ", ".join(f"{v:10.4f}" for v in means.values())
        print(f"[{self.total_steps + 1:6d}, {lr:10.7f}] {metrics_str} "
              f"({rate:.2f} it/s)")
        record = {"step": self.total_steps, "lr": lr,
                  "steps_per_sec": rate, **means}
        self._jsonl.write(json.dumps(record) + "\n")
        self._jsonl.flush()
        if self._writer:
            for k, v in means.items():
                self._writer.add_scalar(k, v, self.total_steps)
        self.running = {}
        self._t0 = time.time()
        self._last_flush_step = self.total_steps + 1

    def push(self, metrics):
        for k, v in metrics.items():
            self.running[k] = self.running.get(k, 0.0) + float(v)
        if self.total_steps % self.sum_freq == self.sum_freq - 1:
            self._flush()
        self.total_steps += 1

    def write_dict(self, results, step=None):
        self._ensure_sinks()
        step = self.total_steps if step is None else step
        self._jsonl.write(json.dumps({"step": step, **{
            k: float(v) for k, v in results.items()}}) + "\n")
        self._jsonl.flush()
        if self._writer:
            for k, v in results.items():
                self._writer.add_scalar(k, float(v), step)

    def close(self):
        # flush a partial window, so that a short run leaves its metrics
        pending = self.total_steps - self._last_flush_step
        if self.running and pending > 0:
            self._flush(count=pending)
        if self._jsonl:
            self._jsonl.close()
        if self._writer:
            self._writer.close()
