"""ac3acm_tpu: an AC-3 (ATSC A/52) codec framework in JAX.

Rebuild of the capabilities of the AC-3 ACM codec (liba52 decoder +
Bellard/fccHandler encoder + ACM shell) as a batched JAX/XLA pipeline with
a native C++ host runtime:

  models.decoder / models.encoder   per-stream codecs (device path)
  parallel.pipeline / .transcode    batched multi-stream + mesh sharding
  host.native                       C++ pre-pass parser & bit-exact decoder
  io.stream                         ACM-shell-equivalent streaming layer
  io.sinks / io.demux               libao-equivalent outputs, PS/TS demux
  a52                               drop-in a52_* / AC3_encode_* API names
  cli                               a52dec-equivalent command-line tools
"""

__version__ = "0.1.0"

from . import tables  # noqa: F401


def set_accuracy(mode: str):
    """Package decode accuracy policy: "reference" (default -- every
    decode path replays the reference's IMDCT op order, bit-exact vs
    the compiled float liba52, the compare.c contract by construction)
    or "fast" (matmul/fused filterbank, max<=0.02 mean<=0.001
    sigma<=0.002 in 16-bit units).  Set before building decoders or
    dispatching batched pipelines."""
    from .models.decoder import set_accuracy as _set
    _set(mode)


__all__ = ["tables", "a52", "set_accuracy"]
