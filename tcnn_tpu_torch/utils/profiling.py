"""Profiling and logging (``tcnn_tpu/utils/profiling.py``).

The reference has no tracing beyond wall-clock prints and an allocated
bytes counter (SURVEY.md §5).  The port's hooks, on ``torch.profiler``
and ``torch.cuda``:

  * ``trace(dir)``           context manager: a ``torch.profiler`` run over
                             everything inside, CPU and CUDA activities,
                             written to ``dir/trace.json`` as a Chrome
                             trace; ``split`` reads it by layer.
  * ``Timer``                host clock that synchronises the CUDA device.
  * ``device_memory_stats``  ``torch.cuda.memory_stats`` of a device (the
                             analog of total_n_bytes_allocated,
                             gpu_memory.h:53-56); ``{}`` where none.
  * ``log``, ``set_verbose`` the logger ``tcnn_tpu_torch`` (replaces the
                             log-callback system, common_host.h:46-69).
"""

from __future__ import annotations

import contextlib
import logging
import os
import tempfile
import time
from typing import Any, Dict, Iterator, Optional

import torch

log = logging.getLogger("tcnn_tpu_torch")


def set_verbose(verbose: bool = True) -> None:
    """≈ tcnn::set_verbose (common_host.h)."""
    log.setLevel(logging.DEBUG if verbose else logging.WARNING)
    if not log.handlers:
        h = logging.StreamHandler()
        h.setFormatter(logging.Formatter("[tcnn_tpu_torch] %(levelname)s: %(message)s"))
        log.addHandler(h)


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None) -> Iterator["torch.profiler.profile"]:
    """Profile everything inside with ``torch.profiler`` (CPU activity, and
    CUDA where a device is present) and write the Chrome trace to
    ``log_dir/trace.json`` (a new temporary directory where None).  Yields
    the profiler: its ``key_averages()`` after the block, ``split`` for a
    summary, ``trace_file`` the trace's path."""
    from torch.profiler import ProfilerActivity, profile

    log_dir = log_dir or tempfile.mkdtemp(prefix="tcnn_tpu_torch_trace_")
    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.trace_file = os.path.join(log_dir, "trace.json")
    with prof:
        yield prof
    prof.export_chrome_trace(prof.trace_file)
    log.debug("trace written to %s", prof.trace_file)


def split(prof: "torch.profiler.profile", top: int = 5) -> Dict[str, Any]:
    """A finished ``trace``'s split of the time: ``device_ms``, the CUDA
    kernels' device time summed (0 where the profiler saw no device
    activity), ``cpu_ms``, the CPU ops' self time summed, and ``top_cpu``,
    the ``top`` CPU ops with the most self time as (name, ms, calls)."""
    from torch.autograd import DeviceType

    events = prof.key_averages()

    def self_device_us(e):
        return getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0.0))

    device = [e for e in events if e.device_type == DeviceType.CUDA]
    cpu = sorted((e for e in events if e.device_type == DeviceType.CPU),
                 key=lambda e: e.self_cpu_time_total, reverse=True)
    return {"device_ms": sum(self_device_us(e) for e in device) / 1e3,
            "cpu_ms": sum(e.self_cpu_time_total for e in cpu) / 1e3,
            "top_cpu": [(e.key, e.self_cpu_time_total / 1e3, e.count) for e in cpu[:top]]}


def _synchronize() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


class Timer:
    """Host clock that synchronises the CUDA device: ``with Timer() as t:
    ...`` then ``t.seconds``.  It waits for the device on entry and exit,
    so work enqueued before the block is not counted and work enqueued in
    it is."""

    def __enter__(self):
        _synchronize()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        _synchronize()
        self.seconds = time.perf_counter() - self._t0
        return False


def device_memory_stats(device: Optional[Any] = None) -> Dict[str, int]:
    """``torch.cuda.memory_stats`` of ``device`` (the current CUDA device
    where None): bytes allocated, reserved, peaks; ``{}`` where the device
    reports none (the CPU, or no CUDA)."""
    device = torch.device("cuda") if device is None else torch.device(device)
    if device.type != "cuda" or not torch.cuda.is_available():
        return {}
    return dict(torch.cuda.memory_stats(device))


def throughput(n_samples: int, seconds: float) -> float:
    return n_samples / max(seconds, 1e-12)
