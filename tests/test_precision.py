"""No f32 matmul on a decode path may run below HIGHEST precision.

On the GPU a DEFAULT-precision f32 dot may execute in TF32 (about three
decimal digits), which would silently break the bit-exact and fast-mode
contracts.  The repo sets no global jax_default_matmul_precision, so
every f32 dot must carry Precision.HIGHEST itself; bf16 dots (the exact
one-hot / triangular products, f32 accumulation) are exact in any mode.
Checked on the lowered StableHLO of each path, so it holds on any
backend."""
import os
import re

import jax
import numpy as np
import pytest

import ac3acm_tpu.tables as T
from ac3acm_tpu.models.decoder import StreamFormat

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
FLAGS = T.A52_STEREO | T.A52_ADJUST_LEVEL
DOT = re.compile(r"stablehlo\.(dot_general|dot|convolution)\b")


def f32_dots_below_highest(hlo: str):
    """(count of f32 dots, the lines of those not at HIGHEST)."""
    n, bad = 0, []
    for line in hlo.splitlines():
        if not DOT.search(line):
            continue
        operands = line.rsplit(":", 1)[-1].split("->")[0]
        if "xf32>" not in operands:
            continue
        n += 1
        if "precision = [HIGHEST, HIGHEST]" not in line:
            bad.append(line.strip())
    return n, bad


def _es():
    with open(os.path.join(GOLDEN, "bench_51_448.ac3"), "rb") as f:
        return f.read()


def _blocks(L=2, nframes=1):
    from ac3acm_tpu.host.native import NativeParser
    blocks, meta = NativeParser().decode_frames(_es(), nframes, FLAGS, 1.0,
                                                384.0)
    fmt = StreamFormat(acmod=meta["acmod"], output=meta["output"],
                       slev_zero=meta["slev"] == 0.0,
                       chanbias=meta["chanbias"])
    return fmt, {k: np.broadcast_to(v, (L,) + v.shape).copy()
                 for k, v in blocks.items()}


def _decode_hlo(exact: bool, steady: bool):
    from ac3acm_tpu.models.decoder import premix_blocks
    from ac3acm_tpu.parallel.pipeline import (batched_pipeline,
                                              init_batched_carry)
    fmt, blocks = _blocks()
    if steady:
        blocks = premix_blocks(fmt, blocks)
    fn = batched_pipeline(fmt, emit_int16=True, steady=steady,
                          long_only=steady, premixed=steady, exact=exact)
    return fn.lower(init_batched_carry(2), blocks).as_text()


def _raw_hlo():
    from ac3acm_tpu.host.native import SideinfoBatchParser
    from ac3acm_tpu.ops.unpack_device import init_unpack_carry, prune_raw_meta
    from ac3acm_tpu.parallel.pipeline import (init_batched_carry,
                                              raw_batched_pipeline)
    L = 2
    r = SideinfoBatchParser(L, nthreads=1).parse([_es()] * L, 1, FLAGS,
                                                 1.0, 384.0)
    recs = r["recs"]
    meta = prune_raw_meta({k: np.ascontiguousarray(recs[k])
                           for k in recs.dtype.names})
    fmt = StreamFormat(acmod=int(r["fmt"][0, 0, 0]),
                       output=int(r["fmt"][0, 0, 1]),
                       slev_zero=bool(r["fmt"][0, 0, 2]),
                       chanbias=int(recs[0, 0]["chanbias"]))
    mb = -(-int(r["fsizes"].max()) // 128) * 128
    fn = raw_batched_pipeline(fmt, emit_int16=True, steady=True,
                              long_only=True)
    carry = (init_unpack_carry(L), init_batched_carry(L))
    return fn.lower(carry, r["frames"][:, :, :mb], meta,
                    np.full((L, 6), 384.0, np.float32)).as_text()


def _transcode_hlo():
    import jax.numpy as jnp
    from ac3acm_tpu.models.encoder import make_config
    from ac3acm_tpu.parallel.transcode import transcode_pipeline
    fmt, blocks = _blocks()
    fn = transcode_pipeline(fmt, make_config(48000, 192000, 2))
    carry = (jnp.zeros((2, 6, 128), jnp.float32), jnp.ones((2,), bool))
    return fn.lower(carry, blocks, jnp.zeros((2, 2, 256), jnp.int32),
                    jnp.full((2,), 40, jnp.int32)).as_text()


CASES = {
    "exact_steady": lambda: _decode_hlo(True, True),
    "fast_steady": lambda: _decode_hlo(False, True),
    "fast_scan": lambda: _decode_hlo(False, False),
    "raw": _raw_hlo,
    "transcode": _transcode_hlo,
}


@pytest.mark.parametrize("path", sorted(CASES))
def test_f32_dots_are_highest(path):
    n, bad = f32_dots_below_highest(CASES[path]())
    assert not bad, bad[:3]
    # the exact body's lane permutations and the fast/transcode
    # filterbank are f32 matmuls: the check must actually see them
    if path != "raw":
        assert n > 0


def test_checker_flags_default_precision():
    """The checker itself: a DEFAULT-precision f32 dot is reported, a
    bf16 one is not."""
    import jax.numpy as jnp
    hlo = jax.jit(lambda a, b: (a @ b, a.astype(jnp.bfloat16)
                                @ b.astype(jnp.bfloat16))).lower(
        jnp.ones((4, 8)), jnp.ones((8, 3))).as_text()
    n, bad = f32_dots_below_highest(hlo)
    assert n == 1 and len(bad) == 1
