"""Hoisted-matmul pipeline == per-block scan of _block_step, exactly."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
from functools import partial

import ac3acm_tpu.tables as T
from ac3acm_tpu.models.decoder import (StreamFormat, _block_step,
                                       _pipeline_body, init_carry)


def _rand_blocks(rng, n):
    q = rng.standard_normal((n, 6, 256)).astype(np.float32) * 3000
    a = (2.0 ** -rng.integers(15, 30, (n, 6, 256))).astype(np.float32)
    b = rng.uniform(0.2, 2.0, (n, 6, 256)).astype(np.float32)
    return {
        "freq": (q * a) * b,
        "blksw": rng.integers(0, 2, (n, 5)).astype(bool),
        "coeff": rng.uniform(0.5, 2.0, (n, 5)).astype(np.float32),
        "remat": rng.integers(0, 2, (n, 256)).astype(bool),
        "bias": np.full(n, 384.0, np.float32),
    }


@pytest.mark.parametrize("fmt", [
    StreamFormat(acmod=T.A52_3F2R, output=T.A52_STEREO, slev_zero=False,
                 chanbias=31),
    StreamFormat(acmod=T.A52_3F2R, output=T.A52_3F2R | T.A52_LFE,
                 slev_zero=False, chanbias=0),
    StreamFormat(acmod=T.A52_STEREO, output=T.A52_STEREO, slev_zero=True,
                 chanbias=0),
    StreamFormat(acmod=T.A52_3F2R, output=T.A52_MONO, slev_zero=False,
                 chanbias=31),
], ids=["51to20", "51id", "stereo", "51tomono"])
def test_hoisted_pipeline_equivalence(fmt):
    rng = np.random.default_rng(3)
    blocks = _rand_blocks(rng, 12)
    ref_fn = jax.jit(lambda c, b: jax.lax.scan(partial(_block_step, fmt), c, b))
    fast_fn = jax.jit(partial(_pipeline_body, fmt))
    c1, p1 = ref_fn(init_carry(), blocks)
    c2, p2 = fast_fn(init_carry(), blocks)
    p1, p2 = np.asarray(p1), np.asarray(p2)
    # identical math modulo matmul accumulation shape (vector-matrix in the
    # scan vs matrix-matrix hoisted): allow ~1 ulp of the peak.  Carries may
    # differ in never-read upper delay planes, so equivalence is checked
    # behaviourally: decode a continuation chunk from each carry.
    tol = 4e-6 * max(np.abs(p1).max(), 1.0)
    np.testing.assert_allclose(p1, p2, rtol=0, atol=tol)
    np.testing.assert_array_equal(np.asarray(c1[1]), np.asarray(c2[1]))
    blocks2 = _rand_blocks(np.random.default_rng(7), 12)
    _, q1 = ref_fn(c1, blocks2)
    _, q2 = fast_fn(c2, blocks2)
    q1, q2 = np.asarray(q1), np.asarray(q2)
    tol2 = 4e-6 * max(np.abs(q1).max(), 1.0)
    np.testing.assert_allclose(q1, q2, rtol=0, atol=tol2)


@pytest.mark.parametrize("fmt", [
    StreamFormat(acmod=T.A52_3F2R, output=T.A52_STEREO, slev_zero=False,
                 chanbias=31),
    StreamFormat(acmod=T.A52_3F2R, output=T.A52_3F2R | T.A52_LFE,
                 slev_zero=False, chanbias=0),
    StreamFormat(acmod=T.A52_STEREO, output=T.A52_STEREO, slev_zero=True,
                 chanbias=0),
    StreamFormat(acmod=T.A52_3F2R, output=T.A52_MONO, slev_zero=False,
                 chanbias=31),
], ids=lambda f: f"acmod{f.acmod}-out{f.output}")
def test_steady_matches_scan(fmt):
    """The scan-free steady pipeline equals the scan pipeline on eligible
    chunks (uniform blksw / nonzero coeffs).

    The two bodies may block the matmul differently (XLA:CPU does), so
    allow 1 ulp at the 384 bias grid."""
    from ac3acm_tpu.models.decoder import (_pipeline_body, _pipeline_steady,
                                           init_carry, steady_ok)
    rng = np.random.default_rng(9)
    n = 12
    blocks = _rand_blocks(rng, n)
    # eligibility: uniform blksw per block (vary across blocks), coeffs != 0
    blocks["blksw"] = np.repeat(
        rng.integers(0, 2, (n, 1)).astype(bool), 5, axis=1)
    assert steady_ok(fmt, blocks)
    for dmx0 in (True, False):
        carry = (np.asarray(init_carry()[0])
                 + rng.standard_normal((6, 128)).astype(np.float32),
                 np.asarray(dmx0))
        c1, p1 = _pipeline_body(fmt, jax.tree.map(jnp.asarray, carry),
                                jax.tree.map(jnp.asarray, blocks))
        c2, p2 = _pipeline_steady(fmt, jax.tree.map(jnp.asarray, carry),
                                  jax.tree.map(jnp.asarray, blocks))
        ulp384 = np.spacing(np.float32(384.0))
        assert np.abs(np.asarray(p1) - np.asarray(p2)).max() <= ulp384
        assert np.abs(np.asarray(c1[0]) - np.asarray(c2[0])).max() <= ulp384
        assert bool(c1[1]) == bool(c2[1])


def test_steady_long_only_matches():
    """The long-only steady specialization equals the dual-matmul steady
    body on all-long chunks."""
    from ac3acm_tpu.models.decoder import _pipeline_steady, init_carry
    fmt = StreamFormat(acmod=T.A52_3F2R, output=T.A52_STEREO,
                       slev_zero=False, chanbias=31)
    rng = np.random.default_rng(21)
    blocks = _rand_blocks(rng, 10)
    blocks["blksw"] = np.zeros((10, 5), bool)          # all long
    carry = jax.tree.map(jnp.asarray, (np.asarray(init_carry()[0]),
                                       np.asarray(True)))
    bj = jax.tree.map(jnp.asarray, blocks)
    c1, p1 = _pipeline_steady(fmt, carry, bj)
    c2, p2 = _pipeline_steady(fmt, carry, bj, long_only=True)
    np.testing.assert_array_equal(np.asarray(p1), np.asarray(p2))
    np.testing.assert_array_equal(np.asarray(c1[0]), np.asarray(c2[0]))


@pytest.mark.parametrize("fmt", [
    StreamFormat(acmod=T.A52_3F2R, output=T.A52_STEREO, slev_zero=False,
                 chanbias=31),
    StreamFormat(acmod=T.A52_3F2R, output=T.A52_3F | T.A52_LFE,
                 slev_zero=False, chanbias=29),
    StreamFormat(acmod=T.A52_STEREO, output=T.A52_MONO, slev_zero=True,
                 chanbias=3),
], ids=lambda f: f"acmod{f.acmod}-out{f.output}")
def test_premixed_matches_steady(fmt):
    """Host-premixed blocks through the premixed steady body equal the
    device-downmix steady body bit-for-bit."""
    from ac3acm_tpu.models.decoder import (_pipeline_steady, init_carry,
                                           premix_blocks, steady_ok)
    rng = np.random.default_rng(33)
    blocks = _rand_blocks(rng, 8)
    blocks["blksw"] = np.repeat(
        rng.integers(0, 2, (8, 1)).astype(bool), 5, axis=1)
    assert steady_ok(fmt, blocks)
    pre = premix_blocks(fmt, blocks)
    assert pre["freq"].shape == (8, fmt.nch_out, 256)
    carry = (jnp.asarray(np.asarray(init_carry()[0])
                         + rng.standard_normal((6, 128)).astype(np.float32)),
             jnp.asarray(True))
    c1, p1 = _pipeline_steady(fmt, carry, jax.tree.map(jnp.asarray, blocks))
    c2, p2 = _pipeline_steady(fmt, carry, jax.tree.map(jnp.asarray, pre),
                              premixed=True)
    np.testing.assert_array_equal(np.asarray(p1), np.asarray(p2))
    # output-plane delays must match (stale upper planes may differ only
    # where the premixed body never wrote them)
    np.testing.assert_array_equal(np.asarray(c1[0])[: fmt.nf_out],
                                  np.asarray(c2[0])[: fmt.nf_out])


@pytest.mark.parametrize("fmt", [
    StreamFormat(acmod=T.A52_STEREO, output=T.A52_STEREO, slev_zero=True,
                 chanbias=0),
    StreamFormat(acmod=T.A52_STEREO, output=T.A52_DOLBY, slev_zero=True,
                 chanbias=0),
    StreamFormat(acmod=T.A52_3F2R, output=T.A52_3F2R | T.A52_LFE,
                 slev_zero=False, chanbias=0),
    StreamFormat(acmod=T.A52_MONO, output=T.A52_MONO, slev_zero=True,
                 chanbias=0),
], ids=["2.0pass", "2.0dolby", "5.1pass", "monopass"])
def test_premixed_passthrough_matches_steady(fmt):
    """Identity-mix passthrough formats (fmt.identity_mix) through the
    premixed time-path steady body equal the generic steady body
    bit-for-bit, including the full delay carry (the premix here is
    rematrix-only; parser-dead planes are zero as the host emits them)."""
    from ac3acm_tpu.models.decoder import (_pipeline_steady, init_carry,
                                           premix_blocks, steady_ok)
    assert fmt.identity_mix
    rng = np.random.default_rng(41)
    n = 8
    blocks = _rand_blocks(rng, n)
    # parser-realistic inputs: planes past the coded channels are zero
    # (the generic body then writes exactly-zero delays there, which the
    # premixed body reproduces), per-channel blksw is allowed on the
    # time path
    blocks["freq"][:, fmt.nfchans:5] = 0.0
    if not fmt.lfe_out:      # LFE rides plane 5 in the generic layout
        blocks["freq"][:, 5:] = 0.0
    assert steady_ok(fmt, blocks)
    pre = premix_blocks(fmt, blocks)
    assert pre["freq"].shape == (n, fmt.nch_out, 256)
    for dmx0 in (True, False):
        carry = (jnp.asarray(np.asarray(init_carry()[0])
                             + rng.standard_normal((6, 128))
                             .astype(np.float32)),
                 jnp.asarray(dmx0))
        c1, p1 = _pipeline_steady(fmt, carry,
                                  jax.tree.map(jnp.asarray, blocks))
        c2, p2 = _pipeline_steady(fmt, carry,
                                  jax.tree.map(jnp.asarray, pre),
                                  premixed=True)
        np.testing.assert_array_equal(np.asarray(p1), np.asarray(p2))
        np.testing.assert_array_equal(np.asarray(c1[0]), np.asarray(c2[0]))
        assert bool(c1[1]) == bool(c2[1])
