"""BatchedDecoder host-pool behaviour: uneven feeds, pending carry, parity.

The multi-stream pool mirrors N independent ACM driver instances
(AC3ACM.cpp:92-102): each lane must decode exactly what a single-stream
decode of the same bytes would produce, regardless of how unevenly the
lanes are fed.
"""
import numpy as np
import pytest

import ac3acm_tpu.tables as T


def _golden_es():
    import os
    path = os.path.join(os.path.dirname(__file__), "golden", "bench_51_448.ac3")
    return open(path, "rb").read()


def _frames(es, n):
    from ac3acm_tpu.host.parse import syncinfo
    out, pos = [], 0
    while len(out) < n and pos + 7 <= len(es):
        size, _, _, _ = syncinfo(es[pos:pos + 7])
        assert size
        out.append(es[pos:pos + size])
        pos += size
    assert len(out) == n
    return out


def _assert_pcm_equal(got, ref):
    """Lane PCM vs a different-batch-shape decode of the same bytes.

    XLA:CPU blocks the f32 filterbank matmul differently per batch shape,
    so a batch-N lane and the batch-1 reference may differ by the
    reassociation error of the 256-term contraction (~1e-7 absolute at
    unit level).  Same-shape comparisons stay bitwise everywhere
    (see test_native_parser_matches_python).
    """
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-6)


def _reference_lane(frames, flags, nblk=None):
    """Single-stream decode of the same frames through the same pipeline."""
    from ac3acm_tpu.parallel.pipeline import BatchedDecoder
    d = BatchedDecoder(1, flags)
    d.feed(0, b"".join(frames))
    out = []
    while True:
        r = d.decode_available(max_frames=len(frames))
        if r is None:
            break
        pcm, valid = r
        assert valid.all()
        out.append(np.asarray(pcm)[0])
    return np.concatenate(out, axis=0)


def test_uneven_feeds_do_not_drop_frames():
    """Frames parsed beyond the emitted batch stay pending on the lane and
    are emitted by later calls (regression: they were silently dropped)."""
    from ac3acm_tpu.parallel.pipeline import BatchedDecoder
    es = _golden_es()
    flags = T.A52_STEREO | T.A52_ADJUST_LEVEL
    frames = _frames(es, 6)

    ref = _reference_lane(frames, flags)
    assert ref.shape[0] == 36                     # 6 frames x 6 blocks

    d = BatchedDecoder(2, flags)
    d.feed(0, b"".join(frames))                   # lane 0: all 6 frames
    d.feed(1, b"".join(frames[:2]))               # lane 1: only 2
    pcm1, valid1 = d.decode_available(max_frames=8)
    assert pcm1.shape[1] == 12 and valid1.all()   # min(6, 2) = 2 frames
    assert len(d.lanes[0].pending) == 4           # parsed, kept for later

    d.feed(1, b"".join(frames[2:]))               # lane 1 catches up
    pcm2, valid2 = d.decode_available(max_frames=8)
    assert pcm2.shape[1] == 24 and valid2.all()   # the 4 pending + 4 new

    for lane in range(2):
        got = np.concatenate(
            [np.asarray(pcm1)[lane], np.asarray(pcm2)[lane]], axis=0)
        _assert_pcm_equal(got, ref)


def test_batched_lanes_match_single_stream():
    """Every lane of a 4-lane batch equals the single-stream decode."""
    from ac3acm_tpu.parallel.pipeline import BatchedDecoder
    es = _golden_es()
    flags = T.A52_STEREO | T.A52_ADJUST_LEVEL
    frames = _frames(es, 4)
    ref = _reference_lane(frames, flags)

    d = BatchedDecoder(4, flags)
    for lane in range(4):
        d.feed(lane, b"".join(frames))
    pcm, valid = d.decode_available(max_frames=4)
    assert valid.all()
    for lane in range(4):
        _assert_pcm_equal(np.asarray(pcm)[lane], ref)


@pytest.mark.parametrize("nlanes,uneven", [(2, False), (3, True)])
def test_native_parser_matches_python(nlanes, uneven):
    """The native dense-parse path produces bit-identical PCM to the
    Python host pass, including pending-frame carry on uneven feeds."""
    from ac3acm_tpu.parallel.pipeline import BatchedDecoder
    es = _golden_es()
    flags = T.A52_STEREO | T.A52_ADJUST_LEVEL
    frames = _frames(es, 6)

    outs = {}
    for kind in ("python", "native"):
        d = BatchedDecoder(nlanes, flags, parser=kind)
        for lane in range(nlanes):
            d.feed(lane, b"".join(frames[:2] if uneven and lane == 0
                                  else frames))
        chunks = []
        r = d.decode_available(max_frames=4)
        assert r is not None
        chunks.append(np.asarray(r[0]))
        if uneven:
            d.feed(0, b"".join(frames[2:]))
        while True:
            r = d.decode_available(max_frames=4)
            if r is None:
                break
            chunks.append(np.asarray(r[0]))
        outs[kind] = np.concatenate(chunks, axis=1)
    assert outs["python"].shape == outs["native"].shape
    np.testing.assert_array_equal(outs["python"], outs["native"])


def test_native_parser_masks_corrupt_frames():
    """A corrupt frame in one lane zeroes that lane-frame (valid=False)
    without desyncing the batch (a52dec resync semantics)."""
    from ac3acm_tpu.parallel.pipeline import BatchedDecoder
    es = _golden_es()
    flags = T.A52_STEEREO if hasattr(T, "A52_STEEREO") else T.A52_STEREO
    frames = _frames(es, 4)
    bad = bytearray(frames[1])
    bad[8:40] = b"\xff" * 32                  # wreck the side-info
    d = BatchedDecoder(2, flags, parser="native")
    d.feed(0, b"".join(frames))
    d.feed(1, frames[0] + bytes(bad) + frames[2] + frames[3])
    r = d.decode_available(max_frames=4)
    assert r is not None
    pcm, valid = r
    assert valid[0].all()
    assert valid[1, 0] and valid[1, 2] and valid[1, 3]
    # frames after the corrupt one still decode: compare against the clean
    # lane where the decoder state allows (frame 0 must match exactly)
    np.testing.assert_array_equal(np.asarray(pcm)[1, :6],
                                  np.asarray(pcm)[0, :6])
