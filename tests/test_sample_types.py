"""LIBA52_FIXED / LIBA52_DOUBLE sample-type backends vs the reference builds.

The reference compiles to float, double, or int32-Q30 fixed sample types
(include/a52.h:27-36); the framework's SampleDecoder must match the
corresponding reference build bit for bit (integer and double arithmetic
are both deterministic).
"""
import os

import numpy as np
import pytest

import ac3acm_tpu.tables as T
from ac3acm_tpu.host.native import SampleDecoder
from tests.refbuild import get_ref_variant

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")

STREAMS = ["bench_51_448.ac3", "stereo_192.ac3", "mono_96.ac3"]
MODES = [
    ("stereo", T.A52_STEREO),
    ("mono", T.A52_MONO),
    ("dolby", T.A52_DOLBY),
    ("full+lfe", T.A52_3F2R | T.A52_LFE),
]


@pytest.mark.parametrize("kind", ["fixed", "double"])
@pytest.mark.parametrize("stream", STREAMS)
def test_sample_type_golden(kind, stream):
    es = open(os.path.join(GOLDEN, stream), "rb").read()
    ref = get_ref_variant(kind)
    for name, flags in MODES:
        _, rb = ref.decode_stream(es, flags)
        # fresh decoder per run: the OLA delay is streaming state
        mine = SampleDecoder(kind).decode_stream(
            es, flags | T.A52_ADJUST_LEVEL)
        m = mine.reshape(mine.shape[0], -1)
        assert rb.shape == m.shape, (name, rb.shape, m.shape)
        np.testing.assert_array_equal(rb, m, err_msg=f"{stream} {name}")


@pytest.mark.parametrize("kind", ["fixed", "double"])
@pytest.mark.parametrize("case", [
    ("stereo_cpl", 11, 2, False, dict(want_cpl=True), T.A52_STEREO),
    ("3f2r_lfe_cpl", 14, 7, True, dict(want_cpl=True), T.A52_3F2R | T.A52_LFE),
    ("blksw_downmix", 15, 7, False, dict(want_blksw=True), T.A52_STEREO),
], ids=lambda c: c[0] if isinstance(c, tuple) else c)
def test_sample_type_fuzz(kind, case):
    """Synthetic streams covering coupling, dither, 256-pt blocks, dynrng,
    delta bit allocation, and downmix-strategy flips."""
    from tests.streamgen import gen_stream
    name, seed, acmod, lfeon, kw, flags = case
    es = gen_stream(seed, acmod, lfeon, nframes=3, **kw)
    ref = get_ref_variant(kind)
    mine = SampleDecoder(kind).decode_stream(es, flags | T.A52_ADJUST_LEVEL)
    _, rb = ref.decode_stream(es, flags)
    m = mine.reshape(mine.shape[0], -1)
    assert rb.shape == m.shape
    np.testing.assert_array_equal(rb, m, err_msg=name)


def test_sample_type_drc_disable():
    es = open(os.path.join(GOLDEN, "bench_51_448.ac3"), "rb").read()
    d = SampleDecoder("double")
    base = d.decode_stream(es, T.A52_STEREO | T.A52_ADJUST_LEVEL)
    d2 = SampleDecoder("double")
    d2.set_drc_enabled(False)
    off = d2.decode_stream(es, T.A52_STEREO | T.A52_ADJUST_LEVEL)
    # this golden stream carries no dynrng codes -> identical; the knob is
    # exercised (and differs) in test_a52_api's generated streams
    assert base.shape == off.shape


def test_fixed_s16_convert():
    """convert(): fixed s16 = clip(sample >> 15) (convert2s16.c:34-41)."""
    es = open(os.path.join(GOLDEN, "stereo_192.ac3"), "rb").read()
    fx = SampleDecoder("fixed").decode_stream(
        es, T.A52_STEREO | T.A52_ADJUST_LEVEL)
    s16 = np.clip(fx >> 15, -32768, 32767).astype(np.int16)
    # float reference path (bias 384, IEEE trick) must agree closely
    from ac3acm_tpu.host.native import NativeDecoder
    fl = NativeDecoder().decode_stream(es, T.A52_STEREO | T.A52_ADJUST_LEVEL,
                                       1.0, 384.0)
    f16 = np.clip(((fl.astype(np.float64) - 384.0) * 32768.0).round(),
                  -32768, 32767).astype(np.int16)
    assert np.abs(s16.astype(np.int32) - f16.astype(np.int32)).max() <= 1


@pytest.mark.parametrize("kind", ["fixed", "double"])
def test_sample_type_halfrate(kind):
    """Half-rate (bsid 9/10) streams through the sample-type backends."""
    from tests.streamgen import gen_stream
    es = gen_stream(31, 2, False, nframes=2, halfratecod=1)
    ref = get_ref_variant(kind)
    _, rb = ref.decode_stream(es, T.A52_STEREO)
    mine = SampleDecoder(kind).decode_stream(
        es, T.A52_STEREO | T.A52_ADJUST_LEVEL)
    m = mine.reshape(mine.shape[0], -1)
    assert rb.shape == m.shape
    np.testing.assert_array_equal(rb, m)


@pytest.mark.parametrize("stream", STREAMS)
def test_fixed_device_backend_golden(stream):
    """SampleDecoder('fixed', backend='device') -- host dequant pre-pass +
    int32 Q30 device filterbank/downmix -- is bit-exact vs the reference
    -DLIBA52_FIXED build (and hence vs the CPU backend)."""
    es = open(os.path.join(GOLDEN, stream), "rb").read()
    ref = get_ref_variant("fixed")
    for name, flags in MODES:
        _, rb = ref.decode_stream(es, flags)
        mine = SampleDecoder("fixed", backend="device").decode_stream(
            es, flags | T.A52_ADJUST_LEVEL)
        m = mine.reshape(mine.shape[0], -1)
        assert rb.shape == m.shape, (name, rb.shape, m.shape)
        np.testing.assert_array_equal(rb, m, err_msg=f"{stream} {name}")


@pytest.mark.parametrize("case", [
    ("stereo_cpl", 11, 2, False, dict(want_cpl=True), T.A52_STEREO),
    ("3f2r_lfe_cpl", 14, 7, True, dict(want_cpl=True), T.A52_3F2R | T.A52_LFE),
    ("blksw_downmix", 15, 7, False, dict(want_blksw=True), T.A52_STEREO),
], ids=lambda c: c[0] if isinstance(c, tuple) else c)
def test_fixed_device_backend_fuzz(case):
    """Device fixed path over synthetic streams: coupling, 256-pt blocks
    (imdct256 in Q30), downmix-strategy flips with the int32 delay carry."""
    from tests.streamgen import gen_stream
    name, seed, acmod, lfeon, kw, flags = case
    es = gen_stream(seed, acmod, lfeon, nframes=3, **kw)
    ref = get_ref_variant("fixed")
    mine = SampleDecoder("fixed", backend="device").decode_stream(
        es, flags | T.A52_ADJUST_LEVEL)
    _, rb = ref.decode_stream(es, flags)
    m = mine.reshape(mine.shape[0], -1)
    assert rb.shape == m.shape
    np.testing.assert_array_equal(rb, m, err_msg=name)
