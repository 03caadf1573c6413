"""Profiling utilities (SURVEY.md §5.1: the device
replacement for the reference's verbose wall-text is jax.profiler traces +
per-iteration timing, which the fit drivers already print with
``verbose=True``)."""

from __future__ import annotations

import contextlib


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a jax.profiler trace of everything inside the context.

    View with TensorBoard or Perfetto:  with trace("/tmp/tb"): model.fit(X)
    """
    import jax

    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


_tracing = False


@contextlib.contextmanager
def maybe_trace():
    """Honor CMFREC_TPU_PROFILE=<logdir>: every fit wrapped in this
    context emits a jax.profiler trace there (TensorBoard / Perfetto
    viewable); unset = zero overhead.  Re-entrant (nested fits, e.g. the
    offsets model's inner ALS, join the outer trace)."""
    import os

    global _tracing
    logdir = os.environ.get("CMFREC_TPU_PROFILE")
    if not logdir or _tracing:
        yield
        return
    _tracing = True
    try:
        with trace(logdir):
            yield
    finally:
        _tracing = False


def profiled_fit(fn):
    """Decorator applying :func:`maybe_trace` around a fit driver."""
    import functools

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with maybe_trace():
            return fn(*args, **kwargs)

    return wrapper

