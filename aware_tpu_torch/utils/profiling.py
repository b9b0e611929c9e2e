"""Profiling hooks: ``trace`` records a ``torch.profiler`` trace of a
block (host and, where there is a card, CUDA activity) and writes it as a
Chrome trace (open in Perfetto or chrome://tracing); ``timed`` logs a
block's wall time.  The port of ``aware_tpu/utils/profiling.py``."""

from __future__ import annotations

import contextlib
import pathlib
import time
from typing import Iterator

import torch

from aware_tpu_torch.utils.logger import logger


@contextlib.contextmanager
def trace(log_dir: str | pathlib.Path) -> Iterator[torch.profiler.profile]:
    """Profile the enclosed block and write ``<log_dir>/trace.json``;
    yields the profiler (``key_averages()`` for a table).  CUDA activity
    is recorded when a card is present, and the card is synchronized
    before the trace stops."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    cuda = torch.cuda.is_available()
    if cuda:
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    out = pathlib.Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
        if cuda:
            torch.cuda.synchronize()
    path = out / "trace.json"
    prof.export_chrome_trace(str(path))
    logger.info("trace written to %s; the block took %.3fs", path, time.perf_counter() - t0)


@contextlib.contextmanager
def timed(label: str) -> Iterator[None]:
    """Wall-clock log of the enclosed block (host side)."""
    t0 = time.time()
    yield
    logger.info("%s: %.3fs", label, time.time() - t0)
