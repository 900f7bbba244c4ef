"""Differential decode fuzzing with synthetic streams.

Covers the decoder paths the reference encoder never produces: coupling
(incl. phase flags and band structure), short blocks (blksw), dynamic
range, delta bit allocation, rematrixing variants, zero-SNR shortcut,
EXP_REUSE chains, and the downmix-strategy flips with the `downmixed`
delay-layout carry.
"""
import numpy as np
import pytest

import ac3acm_tpu.tables as T
from ac3acm_tpu.models.decoder import Decoder
from tests.refbuild import get_ref
from tests.streamgen import gen_stream
from tests.test_decode import compare_oracle

CASES = [
    # (name, seed, acmod, lfeon, kwargs, out_flags)
    ("stereo_cpl", 11, 2, False, dict(want_cpl=True), T.A52_STEREO),
    ("stereo_remat_dynrng", 12, 2, False, dict(), T.A52_STEREO),
    ("3f2r_cpl_to_stereo", 13, 7, False, dict(want_cpl=True), T.A52_STEREO),
    ("3f2r_lfe_cpl_full", 14, 7, True, dict(want_cpl=True),
     T.A52_3F2R | T.A52_LFE),
    ("blksw_mix", 15, 7, False, dict(want_blksw=True), T.A52_STEREO),
    ("blksw_multich", 16, 6, False, dict(want_blksw=True), T.A52_2F2R),
    ("deltba", 17, 3, False, dict(want_deltba=True), T.A52_3F),
    ("zero_snr", 18, 2, False, dict(zero_snr=True), T.A52_STEREO),
    ("mono", 19, 1, False, dict(), T.A52_MONO),
    ("dualmono_ch1", 20, 0, False, dict(), T.A52_CHANNEL1),
    ("2f1r_dolby", 21, 4, False, dict(), T.A52_DOLBY),
    ("3f1r_lfe", 22, 5, True, dict(want_cpl=True), T.A52_3F1R | T.A52_LFE),
    ("51_to_mono", 23, 7, True, dict(want_cpl=True), T.A52_MONO),
    ("blksw_cpl", 24, 7, False, dict(want_cpl=True, want_blksw=True),
     T.A52_STEREO),
]


@pytest.mark.parametrize("name,seed,acmod,lfeon,kw,outf",
                         CASES, ids=[c[0] for c in CASES])
def test_fuzz_decode(name, seed, acmod, lfeon, kw, outf):
    ref = get_ref()
    es = None
    for s in range(seed, seed + 10):
        try:
            es = gen_stream(s, acmod, lfeon, nframes=4, **kw)
            break
        except OverflowError:
            continue
    assert es is not None, "could not generate a fitting stream"

    rflags, ref_blocks = ref.decode_stream(es, outf)
    assert ref_blocks.shape[0] == 24, "reference rejected generated stream"
    dec = Decoder()
    out, fmt = dec.decode_stream(es, outf | T.A52_ADJUST_LEVEL,
                                 level=1.0, bias=0.0)
    assert out.shape[0] == 24
    mine = out.reshape(out.shape[0], -1)
    refb = ref_blocks
    assert mine.shape == refb.shape, (mine.shape, refb.shape)
    # fuzz streams are overdriven (peaks far beyond full scale), so the
    # IMDCT dot-product rounding scales with the peak: use a peak-relative
    # bound (~8x the observed 2.4e-7 relative matmul error) on top of the
    # absolute compare-oracle threshold.
    maxe, mean, std = compare_oracle(mine, refb)
    peak_units = max(np.abs(refb).max(), 1e-9) * 32768
    tol = max(0.01, 2e-6 * peak_units)
    assert maxe <= tol, (maxe, tol, peak_units)
    assert mean <= tol / 10 and std <= tol / 5, (mean, std, tol)


@pytest.mark.parametrize("name,seed,fscod,frmsizecod,halfrate", [
    ("44k1_even", 31, 1, 28, 0),
    ("44k1_odd", 32, 1, 29, 0),
    ("32k", 33, 2, 30, 0),
    ("halfrate_24k", 34, 0, 30, 1),
    ("quarterrate_12k", 35, 0, 32, 2),
])
def test_fuzz_rates(name, seed, fscod, frmsizecod, halfrate):
    """Sample-rate / halfrate-bsid coverage (fscod formulas, bsid 9/10)."""
    from tests.streamgen import gen_stream
    ref = get_ref()
    es = gen_stream(seed, 7, False, nframes=3, fscod=fscod,
                    frmsizecod=frmsizecod, halfratecod=halfrate,
                    want_cpl=True)
    rflags, ref_blocks = ref.decode_stream(es, T.A52_STEREO)
    assert ref_blocks.shape[0] == 18, "reference rejected stream"
    # bit-exact native decode
    from ac3acm_tpu.host.native import NativeDecoder
    out = NativeDecoder().decode_stream(es, T.A52_STEREO | T.A52_ADJUST_LEVEL)
    np.testing.assert_array_equal(out.reshape(out.shape[0], -1), ref_blocks)
    # device pipeline within tolerance
    dec = Decoder()
    out2, fmt = dec.decode_stream(es, T.A52_STEREO | T.A52_ADJUST_LEVEL)
    mine = out2.reshape(out2.shape[0], -1)
    peak_units = max(np.abs(ref_blocks).max(), 1e-9) * 32768
    maxe, mean, std = compare_oracle(mine, ref_blocks)
    assert maxe <= max(0.01, 2e-6 * peak_units), maxe
