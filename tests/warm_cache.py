"""Seed the per-machine jit cache for the test suite.

The pytest process only READS the persistent compile cache (writing from a
long-lived process trips an XLA:CPU serialize segfault -- see
tests/conftest.py).  This script compiles each heavy pipeline family in a
fresh short-lived subprocess with writes enabled, so subsequent suite runs
start warm.  Run once per machine:

    python tests/warm_cache.py
"""
from __future__ import annotations

import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)

_PRELUDE = """
import os
os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()
import jax
from ac3acm_tpu.utils.cache import enable_compile_cache
enable_compile_cache()
jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
import numpy as np
"""

JOBS = {
    "encoder+packed": """
from ac3acm_tpu.parallel.encode import BatchedEncoder
rng = np.random.default_rng(0)
for nch, kbps in ((2, 192), (6, 640), (2, 32)):
    pcm = (rng.standard_normal((2, 3 * 1536, nch)) * 2000).astype('int16')
    try:
        BatchedEncoder(2, 48000, kbps * 1000, nch).encode_frames(pcm)
    except RuntimeError:
        pass                        # rate-control failure still compiles
""",
    "decoder": """
import ac3acm_tpu.tables as T
from ac3acm_tpu.models.decoder import Decoder
from tests.refbuild import get_ref
from tests.test_decode import make_pcm
es = get_ref().encode(make_pcm(2, 2, seed=1), 48000, 192)
for exact in (False, True):
    Decoder(exact=exact).decode_stream(
        es, T.A52_STEREO | T.A52_ADJUST_LEVEL)
""",
    "transcode": """
import ac3acm_tpu.tables as T
from ac3acm_tpu.parallel.transcode import Transcoder
from ac3acm_tpu.io.demux import es_frames
es = open(os.path.join(%r, "golden", "bench_51_448.ac3"), "rb").read()
frames = [f for f, _, _ in es_frames(es)][:2]
tc = Transcoder(batch=2, out_bitrate=192000, out_channels=2)
tc.step_frames([b"".join(frames)] * 2, len(frames))
""" % (HERE,),
}


def main():
    for name, body in JOBS.items():
        print(f"warming {name} ...", flush=True)
        r = subprocess.run([sys.executable, "-c", _PRELUDE + body],
                           cwd=REPO)
        print(f"  -> exit {r.returncode}", flush=True)


if __name__ == "__main__":
    main()
