"""Tracing / profiling (aux-subsystem parity, SURVEY.md §5).

The reference has the CLI fps meter, a gprof build flag, and the ACM
message logfile.  Equivalents here: jax.profiler traces (XPlane, viewable in
TensorBoard/Perfetto), the FpsMeter, and structured negotiation logging.
"""
from __future__ import annotations

import contextlib
import logging
import os

log = logging.getLogger("ac3acm_tpu")


def setup_logging(path: str | None = None, level=logging.INFO):
    """AC3ACM_LOGFILE analogue: structured log of negotiation/stream events."""
    handler = (logging.FileHandler(path) if path
               else logging.StreamHandler())
    handler.setFormatter(logging.Formatter(
        "%(asctime)s %(name)s %(levelname)s %(message)s"))
    log.addHandler(handler)
    log.setLevel(level)
    return log


def log_format_negotiation(direction: str, src, dst):
    log.info("format_suggest %s: %s -> %s", direction, src, dst)


@contextlib.contextmanager
def profile(trace_dir: str | None = None):
    """jax.profiler trace context (--enable-gprof analogue).

    with profile("traces"): decode(...)
    then: tensorboard --logdir traces
    (default: $AC3ACM_TRACE_DIR, else ac3acm_trace in the temp dir)
    """
    import tempfile
    import jax
    trace_dir = trace_dir or os.environ.get(
        "AC3ACM_TRACE_DIR", os.path.join(tempfile.gettempdir(),
                                         "ac3acm_trace"))
    jax.profiler.start_trace(trace_dir)
    try:
        yield trace_dir
    finally:
        jax.profiler.stop_trace()
