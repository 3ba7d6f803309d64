"""Observability: structured timing, device-true sync, profiler traces.

The reference's observability is stdout narration and a manual
cudaMemGetInfo probe (SURVEY.md §5); here:

  * ``sync(x)`` — block until every leaf of ``x`` is computed
    (``jax.block_until_ready``); returns ``x``;
  * ``Timer`` — wall-clock spans with device sync and derived rates
    (voxel-updates/s, rays/s — the BASELINE metrics);
  * ``trace(name)`` — ``jax.profiler`` annotation context;
  * ``profile_to(dir)`` — capture a TensorBoard-loadable trace.
"""

from __future__ import annotations

import contextlib
import json
import logging
import time
from typing import Optional

import jax

log = logging.getLogger("tsdf_tpu")


def sync(x):
    """Block until every leaf of x is computed; returns x."""
    return jax.block_until_ready(x)


class Timer:
    """Timed span with derived rates.

    >>> with Timer("integrate", voxels=512**3) as t:
    ...     vol = integrate(vol, depth, cam)
    ...     t.result = vol
    """

    def __init__(self, name: str, **counts):
        self.name = name
        self.counts = counts
        self.result = None
        self.elapsed: Optional[float] = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is None and self.result is not None:
            sync(self.result)
        self.elapsed = time.perf_counter() - self._t0
        rates = {
            f"{k}_per_s": v / self.elapsed for k, v in self.counts.items()
        }
        log.info(
            "%s",
            json.dumps(
                {
                    "span": self.name,
                    "ms": round(self.elapsed * 1e3, 3),
                    **rates,
                }
            ),
        )
        return False

    def rate(self, key: str) -> float:
        return self.counts[key] / self.elapsed


@contextlib.contextmanager
def trace(name: str):
    """Annotate a region in jax.profiler traces."""
    with jax.profiler.TraceAnnotation(name):
        yield


@contextlib.contextmanager
def profile_to(log_dir: str):
    """Capture a device trace viewable in TensorBoard/XProf."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def configure_logging(level=logging.INFO) -> None:
    """Structured (one-JSON-line) logging to stderr.

    Idempotent: repeated calls only adjust the level — a handler is
    added once, so re-configuring never duplicates output lines.
    """
    if not log.handlers:
        handler = logging.StreamHandler()
        handler.setFormatter(
            logging.Formatter("%(asctime)s %(name)s %(message)s")
        )
        log.addHandler(handler)
    log.setLevel(level)
