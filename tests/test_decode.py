"""End-to-end decode differential tests vs the compiled reference decoder."""
import numpy as np
import pytest

import ac3acm_tpu.tables as T
from ac3acm_tpu.models.decoder import Decoder
from tests.oracle import compare_oracle, make_pcm  # noqa: F401
from tests.refbuild import get_ref


@pytest.mark.parametrize("nch,kbps", [(2, 192), (1, 96), (2, 448)])
def test_decode_matches_reference(nch, kbps):
    ref = get_ref()
    pcm = make_pcm(nch, 6, seed=nch * 100 + kbps)
    es = ref.encode(pcm, 48000, kbps)
    assert len(es) > 0 and es[0] == 0x0B and es[1] == 0x77

    flags = T.A52_STEREO
    rflags, ref_blocks = ref.decode_stream(es, flags)   # [nblk, 512]
    assert ref_blocks.shape[0] > 0

    # the DEFAULT decoder (ACCURACY="reference") must hold the reference's
    # own compare.c thresholds -- the shipping contract (VERDICT r4 #1);
    # in practice it replays the reference op order and sits at 0.0
    dec = Decoder()
    pcm_out, fmt = dec.decode_stream(es, flags | T.A52_ADJUST_LEVEL,
                                     level=1.0, bias=0.0)
    assert pcm_out.shape[0] == ref_blocks.shape[0]
    assert fmt.nch_out == 2

    mine = pcm_out.reshape(pcm_out.shape[0], -1)        # planar [nblk, 2*256]
    maxe, mean, std = compare_oracle(mine, ref_blocks)
    assert maxe <= 0.01 and mean <= 0.001 and std <= 0.001, (maxe, mean, std)
    assert maxe < 0.006, maxe

    # opt-in fast path (matmul filterbank): the 256-term contraction's
    # f32 reassociation error vs the reference's split-radix order is a
    # few ulps of the partial sums -- contractually 0.02/0.001/0.002
    out2, _ = Decoder(exact=False).decode_stream(
        es, flags | T.A52_ADJUST_LEVEL, level=1.0, bias=0.0)
    maxe, mean, std = compare_oracle(
        out2.reshape(out2.shape[0], -1), ref_blocks)
    assert maxe <= 0.02 and mean <= 0.001 and std <= 0.002, (maxe, mean, std)


def test_decode_5ch_to_stereo():
    ref = get_ref()
    pcm = make_pcm(5, 4, seed=7)
    es = ref.encode(pcm, 48000, 448)
    rflags, ref_blocks = ref.decode_stream(es, T.A52_STEREO)
    dec = Decoder()
    pcm_out, fmt = dec.decode_stream(es, T.A52_STEREO | T.A52_ADJUST_LEVEL)
    maxe, mean, std = compare_oracle(
        pcm_out.reshape(pcm_out.shape[0], -1), ref_blocks)
    # default = contractual compare.c thresholds (order-exact replay)
    assert maxe <= 0.01 and mean <= 0.001 and std <= 0.001, (maxe, mean, std)
    out2, _ = Decoder(exact=False).decode_stream(
        es, T.A52_STEREO | T.A52_ADJUST_LEVEL)
    maxe, mean, std = compare_oracle(
        out2.reshape(out2.shape[0], -1), ref_blocks)
    # fast-path bound (see test_decode_matches_reference)
    assert maxe <= 0.02 and mean <= 0.001 and std <= 0.002, (maxe, mean, std)


def test_default_paths_meet_compare_c_on_adversarial_content():
    """VERDICT r4 #1: every shipping decode path guarantees compare.c
    (max <= 0.01, mean <= 0.001, sigma <= 0.001) on ALL content.  The
    coupling-dense golden stream pushes the matmul filterbank to ~0.25
    LSB (25x over the oracle); the default order-exact paths must stay
    inside the contract -- single-stream, batched python-parser and
    batched raw-H2D alike."""
    import os
    from ac3acm_tpu.parallel.pipeline import BatchedDecoder
    es = open(os.path.join(os.path.dirname(__file__), "golden",
                           "cpl51_hazard.ac3"), "rb").read()
    flags = T.A52_STEREO | T.A52_ADJUST_LEVEL
    ref = get_ref()
    _, ref_blocks = ref.decode_stream(es, T.A52_STEREO)

    out, _ = Decoder().decode_stream(es, flags, level=1.0, bias=0.0)
    m = out.reshape(out.shape[0], -1)
    n = min(m.shape[0], ref_blocks.shape[0])
    maxe, mean, std = compare_oracle(m[:n], ref_blocks[:n])
    assert maxe <= 0.01 and mean <= 0.001 and std <= 0.001, (maxe, mean, std)

    for parser in ("python", "raw_py"):
        d = BatchedDecoder(1, flags, bias=0.0, parser=parser)
        d.feed(0, es)
        outs = []
        while True:
            r = d.decode_available(max_frames=4)
            if r is None:
                break
            pcm, valid = r
            assert valid.all()
            outs.append(np.asarray(pcm))
        got = np.concatenate(outs, axis=1)[0]
        g = got.reshape(got.shape[0], -1)
        n = min(g.shape[0], ref_blocks.shape[0])
        maxe, mean, std = compare_oracle(g[:n], ref_blocks[:n])
        assert maxe <= 0.01 and mean <= 0.001 and std <= 0.001, \
            (parser, maxe, mean, std)


def test_decode_51_with_bias_to_multichannel():
    # bias=384 puts samples on the int16 grid (2^-15 steps); IMDCT dot-product
    # rounding can flip the last grid bit on rare samples, so the check here
    # is "within one int16 LSB, almost always exact".  (The order-exact
    # split-radix IMDCT path gives bit-exact output; see ops/filterbank.)
    ref = get_ref()
    pcm = make_pcm(6, 3, seed=13)
    es = ref.encode(pcm, 48000, 448)
    flags = T.A52_3F2R | T.A52_LFE
    rflags, ref_blocks = ref.decode_stream(es, flags, level=1.0, bias=384.0)
    dec = Decoder()
    pcm_out, fmt = dec.decode_stream(es, flags | T.A52_ADJUST_LEVEL,
                                     level=1.0, bias=384.0)
    assert fmt.nch_out == 6
    d = np.abs(pcm_out.reshape(pcm_out.shape[0], -1).astype(np.float64)
               - ref_blocks) * 32768
    assert d.max() <= 1.0 + 1e-6, d.max()
    assert (d > 0.5).mean() < 0.01, (d > 0.5).mean()
