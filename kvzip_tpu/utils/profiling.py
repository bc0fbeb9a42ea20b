"""Phase timers + device memory reporting (reference `utils/func.py:42-79`:
jax device memory_stats; optional jax.profiler trace capture)."""

from __future__ import annotations

import contextlib
from time import time

import jax


def device_mem_gb() -> tuple:
    """(allocated GB, limit GB) of the default device. Raises where the
    device keeps no memory statistics (the CPU keeps none)."""
    dev = jax.devices()[0]
    stats = dev.memory_stats()
    if not stats:
        raise RuntimeError(f"{dev.platform} device reports no memory stats")
    return stats["bytes_in_use"] / 1024 ** 3, stats["bytes_limit"] / 1024 ** 3


def sync():
    """Wait for pending side effects (the engine blocks on its own chunks)."""
    jax.effects_barrier()


class TimeStamp:
    """Phase timer: `tt = TimeStamp(); ...; tt("phase", denominator=n)`."""

    def __init__(self, verbose: bool = True, precision: int = 1,
                 unit: str = "s"):
        self.verbose = verbose
        self.precision = precision
        self.unit = unit
        self.set()

    def set(self):
        if self.verbose:
            sync()
            self.start = time()

    def elapsed(self, denominator: float = 1.0) -> float:
        val = time() - self.start
        if self.unit == "ms":
            val *= 1000
        return round(val / denominator, self.precision)

    def __call__(self, msg: str = "", denominator: float = 1.0):
        if self.verbose:
            sync()
            mem = ""
            if jax.devices()[0].platform != "cpu":
                alloc, limit = device_mem_gb()
                mem = f" Mem: {alloc:.2f}/{limit:.2f} GB."
            tt = self.elapsed(denominator)
            print(f"## Time: {tt}{self.unit}.{mem} [{msg}]", flush=True)
            self.set()


@contextlib.contextmanager
def profile_trace(logdir: str):
    """jax.profiler trace around a region (view with tensorboard/xprof)."""
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
