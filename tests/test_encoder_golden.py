"""Device encoder vs the committed reference-encoded streams: the encoder
(device encode + on-device pack) must reproduce each stream byte for byte
from the PCM it was made from (tests/oracle.py regenerates that PCM from
its seed), with no reference checkout needed."""
import os

import numpy as np
import pytest

from ac3acm_tpu.parallel.encode import BatchedEncoder
from tests.oracle import ENC_SPECS, enc_spec_pcm

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")

# stereo441_128, halfrate24_64 and quarterrate12_32 are not reproduced by
# the encoder on any backend (ROADMAP C9); every other reference-encoded
# stream is
REPRODUCED = ("bench_51_448.ac3", "stereo_192.ac3", "mono_96.ac3",
              "s51_441_384.ac3", "stereo32_96.ac3", "overdrive_51_448.ac3")


@pytest.mark.parametrize("spec", [s for s in ENC_SPECS if s[0] in REPRODUCED],
                         ids=lambda s: s[0])
def test_device_encoder_matches_committed_stream(spec):
    name, nch, kbps, freq = spec[:4]
    pcm = enc_spec_pcm(spec)
    lanes = 2
    out = BatchedEncoder(lanes, freq, kbps * 1000, nch).encode_frames(
        np.broadcast_to(pcm, (lanes,) + pcm.shape).copy())
    with open(os.path.join(GOLDEN, name), "rb") as f:
        want = f.read()
    assert all(o == want for o in out)
