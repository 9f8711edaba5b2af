"""Throughput and model-FLOPs (MFU) counters, and a device trace on demand.

Counterpart of ``rel_pose_tpu/utils/profiling.py``:

  * ``StepTimer`` (``:16-75``): host-clock step time, pairs/s per GPU and
    MFU, the first ``warmup`` steps skipped.  A data-parallel run passes
    the global batch as ``pairs_per_step``, its FLOPs as
    ``flops_per_step`` and its world size as ``num_chips``, as
    ``train.py:198`` passes the mesh's size.  The training CLI ticks it
    once a step after queueing the step on the card; over many steps the
    queue reaches a steady state and the mean is the device's rate, or the
    host's where the host is slower;
  * ``count_matmul_flops`` / ``estimate_step_flops`` (``:80-155``): the
    matmul and convolution FLOPs (2 x MACs) of one step, counted by
    ``torch.utils.flop_counter.FlopCounterMode`` on the plain path
    (``kernels=False``) on the meta device: no memory, no device, no
    kernel.  The hand kernels compute the same products and are opaque to
    the counter, as the Pallas kernels are to JAX's jaxpr walk;
  * ``peak_flops``: the per-GPU peak the MFU is read against
    (``train.py:173-180``): ``$RELPOSE_PEAK_TFLOPS``, else the H100 SXM's
    989 TFLOP/s dense bf16 for a bf16 model on that card, else None, and
    MFU is left out rather than guessed;
  * ``trace`` (``:159-171``): a ``torch.profiler`` trace of the block when
    a directory is given or ``$RELPOSE_TRACE_DIR`` is set, exported as a
    Chrome trace (``trace_<pid>_<n>.json``) into it.

The counter counts what the step computes: a weight-gradient or an
input-gradient convolution by the product it is, so that a training step
counts its backward convolutions at their forward's MACs.  The JAX
package's ``jaxpr_matmul_flops`` reads every convolution's kernel as OIHW
(``:113-122``), so it counts a weight-gradient convolution, whose kernel
operand is the cotangent, at the cotangent's size a product (the
extractor's 5x5 one 48x too high): at the flagship its train step reads
6.7x this count.  ``tests/test_torch_profiling.py`` holds this count to
that trace recounted with the convolutions' dimension numbers.
"""

import contextlib
import itertools
import os
import time

# the H100 SXM's dense bf16 tensor-core peak (NVIDIA data sheet, 700 W)
H100_BF16_PEAK = 989e12
H100_SXM_NAMES = ("NVIDIA H100 80GB HBM3",)


class StepTimer:
    """Mean step time, throughput and MFU after ``warmup`` steps."""

    def __init__(self, pairs_per_step, num_chips=1, warmup=5,
                 flops_per_step=None, peak_flops=None):
        self.pairs_per_step = pairs_per_step
        self.num_chips = max(1, num_chips)
        self.warmup = warmup
        self.flops_per_step = flops_per_step      # global (whole batch)
        self.peak_flops = peak_flops              # per GPU
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

    @property
    def mfu(self):
        """Achieved matmul / conv FLOPs per GPU over its peak; None unless
        both ``flops_per_step`` (global) and ``peak_flops`` (per GPU) were
        given."""
        if not self.flops_per_step or not self.peak_flops:
            return None
        per_chip = self.flops_per_step / self.num_chips
        return self.steps_per_sec * per_chip / self.peak_flops

    def metrics(self):
        out = {"steps_per_sec": self.steps_per_sec,
               "pairs_per_sec_per_chip": self.pairs_per_sec_per_chip}
        if self.mfu is not None:
            out["mfu"] = self.mfu
        return out


# ------------------------------------------------------- model FLOPs (MFU) --

def count_matmul_flops(fn, *args, **kwargs):
    """Matmul and convolution FLOPs (2 x MACs) of ``fn(*args, **kwargs)``,
    its backward included if ``fn`` calls one: every ``mm``, ``bmm``,
    ``addmm``, ``baddbmm``, convolution and convolution backward that
    ``FlopCounterMode`` sees.  Elementwise and reduction work is left out,
    the numerator convention of MFU."""
    from torch.utils.flop_counter import FlopCounterMode
    with FlopCounterMode(display=False) as counter:
        fn(*args, **kwargs)
    return counter.get_total_flops()


def estimate_step_flops(cfg, batch, mode="train"):
    """Matmul / conv FLOPs of one step of ``batch`` pairs of the model
    ``cfg`` describes, on the plain path on the meta device: ``mode``
    "eval", the forward under ``no_grad`` in eval mode; "train",
    ``train.step.loss_fn`` in training mode and its ``backward()``.  The
    images are resized to 224 first, so the count does not depend on
    their size.  Inside a data-parallel world it counts what one process
    computes on ``batch`` pairs: training BatchNorm's all-reduce of meta
    tensors moves nothing, over gloo and NCCL alike, and counts no FLOP.
    Returns None if the count fails, as the JAX package's
    does (``rel_pose_tpu/utils/profiling.py:140-147``: a logging estimate
    must not stop training); ``$RELPOSE_DEBUG_TRACE`` raises instead."""
    import torch
    from ..models.vitess import ViTEss
    from ..train.step import loss_fn
    if mode not in ("eval", "train"):
        raise ValueError(f"mode {mode!r}: eval or train")
    try:
        model = ViTEss(cfg, device="meta", kernels=False)
        images = torch.empty((batch, 2, 3, 384, 512), dtype=torch.uint8,
                             device="meta")
        poses = torch.empty((batch, 2, 7), device="meta")
        intrinsics = torch.empty((batch, 2, 4), device="meta")
        if mode == "eval":
            def step():
                with torch.no_grad():
                    model(images, intrinsics)
        else:
            model.train()

            def step():
                loss, _, _ = loss_fn(model, images, poses, intrinsics)
                loss.backward()
        return count_matmul_flops(step)
    except Exception:
        if os.environ.get("RELPOSE_DEBUG_TRACE"):
            raise
        return None


def env_peak_flops():
    """``$RELPOSE_PEAK_TFLOPS`` x 1e12, or None where it is not set."""
    env = os.environ.get("RELPOSE_PEAK_TFLOPS")
    return float(env) * 1e12 if env else None


def peak_flops(device, compute_dtype):
    """The per-GPU peak FLOP/s that MFU is read against:
    ``$RELPOSE_PEAK_TFLOPS`` x 1e12 when set; else 989e12 for a bfloat16
    model on an H100 SXM (``NVIDIA H100 80GB HBM3``); else None (no MFU:
    another card's or dtype's peak is not guessed)."""
    env = env_peak_flops()
    if env:
        return env
    import torch
    device = torch.device(device)
    if (device.type == "cuda" and compute_dtype == "bfloat16"
            and torch.cuda.get_device_name(device) in H100_SXM_NAMES):
        return H100_BF16_PEAK
    return None


# ------------------------------------------------------------------ trace --

_trace_ids = itertools.count()


@contextlib.contextmanager
def trace(log_dir=None):
    """Profile the block with ``torch.profiler`` (CPU, and CUDA where a
    GPU is visible) if ``log_dir`` or ``$RELPOSE_TRACE_DIR`` names a
    directory, and export a Chrome trace there.  Yields the profiler, whose
    ``trace_path`` is the file once the block has ended, or None when no
    directory is configured."""
    log_dir = log_dir or os.environ.get("RELPOSE_TRACE_DIR")
    if not log_dir:
        yield None
        return
    import torch
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    path = os.path.join(log_dir,
                        f"trace_{os.getpid()}_{next(_trace_ids)}.json")
    prof.export_chrome_trace(path)
    prof.trace_path = path
