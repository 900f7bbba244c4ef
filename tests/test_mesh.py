"""Multi-chip sharding correctness in the test suite (make-check parity:
test/Makefile.am:8 wires every oracle into the suite; here the sharded
paths must equal their unsharded outputs on the virtual 8-device CPU mesh
that conftest.py configures).
"""
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

import ac3acm_tpu.tables as T

pytestmark = pytest.mark.usefixtures("eight_devices")

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")


def _golden_blocks(nframes=4):
    """Real coded blocks from the golden 5.1 stream + its StreamFormat."""
    from ac3acm_tpu.host.native import NativeParser
    from ac3acm_tpu.models.decoder import StreamFormat
    es = open(os.path.join(GOLDEN, "bench_51_448.ac3"), "rb").read()
    p = NativeParser()
    blocks, meta = p.decode_frames(es, nframes, T.A52_STEREO
                                   | T.A52_ADJUST_LEVEL, 1.0, 384.0)
    fmt = StreamFormat(acmod=meta["acmod"], output=meta["output"],
                       slev_zero=meta["slev"] == 0.0,
                       chanbias=meta["chanbias"])
    return fmt, blocks


def test_sharded_batched_pipeline_matches_unsharded():
    """batched_pipeline(mesh) over a 4x2 mesh == the single-device result,
    bitwise, on real coded content with distinct per-lane carries."""
    from ac3acm_tpu.parallel.mesh import make_mesh
    from ac3acm_tpu.parallel.pipeline import batched_pipeline
    fmt, blocks1 = _golden_blocks()
    batch = 16
    rng = np.random.default_rng(7)
    blocks = jax.tree.map(
        lambda x: np.broadcast_to(x, (batch,) + x.shape).copy(), blocks1)
    # make lanes distinct: per-lane gain jitter on the freq planes
    blocks["freq"] = (blocks["freq"]
                     * (1.0 + rng.uniform(-0.1, 0.1, (batch, 1, 1, 1)))
                     ).astype(np.float32)
    delay0 = rng.standard_normal((batch, 6, 128)).astype(np.float32) * 0.01
    carry = (jnp.asarray(delay0), jnp.ones((batch,), bool))

    fn_local = batched_pipeline(fmt)
    c_ref, pcm_ref = fn_local(carry, blocks)

    mesh = make_mesh(data=4, model=2)
    shard = NamedSharding(mesh, P("data"))
    fn_mesh = batched_pipeline(fmt, mesh=mesh)
    carry_s = jax.tree.map(lambda x: jax.device_put(x, shard), carry)
    blocks_s = jax.tree.map(
        lambda x: jax.device_put(jnp.asarray(x), shard), blocks)
    c_mesh, pcm_mesh = fn_mesh(carry_s, blocks_s)

    np.testing.assert_array_equal(np.asarray(pcm_ref), np.asarray(pcm_mesh))
    np.testing.assert_array_equal(np.asarray(c_ref[0]), np.asarray(c_mesh[0]))
    np.testing.assert_array_equal(np.asarray(c_ref[1]), np.asarray(c_mesh[1]))


def test_tp_filterbank_matches_filterbank():
    """Tensor-parallel filterbank (contraction sharded over 'model' with an
    explicit psum) == the local filterbank within 1 ulp."""
    from ac3acm_tpu.ops.filterbank import filterbank
    from ac3acm_tpu.parallel.mesh import make_mesh
    from ac3acm_tpu.parallel.pipeline import tp_filterbank
    rng = np.random.default_rng(3)
    B, C = 8, 4
    coeffs = rng.standard_normal((B, C, 256)).astype(np.float32) * 1e-3
    delay = rng.standard_normal((B, C, 128)).astype(np.float32) * 1e-3
    blksw = np.zeros((B, C), bool)
    bias = np.full((B, C), 384.0, np.float32)

    out_ref, d_ref = filterbank(jnp.asarray(coeffs), jnp.asarray(delay),
                                jnp.asarray(blksw), jnp.asarray(bias))

    mesh = make_mesh(data=4, model=2)
    fn = jax.jit(lambda c, d, b, bi: tp_filterbank(mesh, c, d, b, bi))
    out_tp, d_tp = fn(coeffs, delay, blksw, bias)

    # psum splits the 256-term contraction into per-shard partial sums --
    # a different f32 accumulation order, so allow a few ulps at the
    # tensor's full-scale magnitude
    for got, ref in ((out_tp, out_ref), (d_tp, d_ref)):
        got, ref = np.asarray(got), np.asarray(ref)
        tol = 8 * np.spacing(np.float32(np.abs(ref).max()))
        assert np.abs(got - ref).max() <= tol


def test_sharded_transcode_matches_unsharded():
    """The fused decode->re-encode step sharded over 'data' produces the
    same encoder fields as the unsharded step.

    SPMD compiles the per-device shape [1, ...] while the unsharded run
    compiles [B, ...]; XLA:CPU blocks the f32 filterbank matmuls
    differently for the two shapes, so the decoded PCM may differ by one
    int16 LSB after rounding.  Structural encoder decisions (bap,
    strategies, exponents, SNR offsets) must be bitwise identical; the
    PCM-derived values (i16, qmant, new_last) are held to +-1 LSB."""
    from ac3acm_tpu.models.encoder import make_config
    from ac3acm_tpu.parallel.mesh import make_mesh
    from ac3acm_tpu.parallel.transcode import transcode_pipeline
    fmt, blocks1 = _golden_blocks(nframes=1)
    batch = 8
    blocks = jax.tree.map(
        lambda x: jnp.asarray(np.broadcast_to(x, (batch,) + x.shape).copy()),
        blocks1)
    cfg = make_config(48000, 192000, 2)
    dec_carry = (jnp.zeros((batch, 6, 128), jnp.float32),
                 jnp.ones((batch,), bool))
    enc_last = jnp.zeros((batch, 2, 256), jnp.int32)
    enc_csnr = jnp.full((batch,), 40, jnp.int32)

    fn_ref = transcode_pipeline(fmt, cfg)
    _, enc_ref, i16_ref = fn_ref(dec_carry, blocks, enc_last, enc_csnr)

    mesh = make_mesh(data=8, model=1)
    shard = NamedSharding(mesh, P("data"))
    put = lambda t: jax.tree.map(lambda x: jax.device_put(x, shard), t)
    fn_mesh = transcode_pipeline(fmt, cfg, mesh)
    _, enc_mesh, i16_mesh = fn_mesh(put(dec_carry), put(blocks),
                                    jax.device_put(enc_last, shard),
                                    jax.device_put(enc_csnr, shard))

    def lsb1(a, b, name):
        d = np.abs(np.asarray(a, np.int64) - np.asarray(b, np.int64))
        assert d.max() <= 1, (name, d.max())

    lsb1(i16_ref, i16_mesh, "i16")
    for k in enc_ref:
        if k in ("qmant", "new_last"):
            lsb1(enc_ref[k], enc_mesh[k], k)
        else:
            np.testing.assert_array_equal(np.asarray(enc_ref[k]),
                                          np.asarray(enc_mesh[k]), err_msg=k)


def test_sharded_batched_decoder_end_to_end():
    """BatchedDecoder(mesh=...) bytes->PCM equals the unsharded decoder
    to 1 ulp at the 384 bias (native parser, premixed steady path
    included; the SPMD per-device shape blocks the f32 filterbank matmul
    differently from the unsharded shape, see
    test_sharded_transcode_matches_unsharded)."""
    from ac3acm_tpu.parallel.mesh import make_mesh
    from ac3acm_tpu.parallel.pipeline import BatchedDecoder
    es = open(os.path.join(GOLDEN, "bench_51_448.ac3"), "rb").read()
    flags = T.A52_STEREO | T.A52_ADJUST_LEVEL

    outs = {}
    for mesh in (None, make_mesh(data=8, model=1)):
        d = BatchedDecoder(8, flags, bias=384.0, mesh=mesh, parser="native")
        for lane in range(8):
            d.feed(lane, es)
        pcm, valid = d.decode_available(max_frames=4)
        assert valid.all()
        outs["mesh" if mesh else "local"] = np.asarray(pcm)
    tol = np.spacing(np.float32(384.0))
    assert np.abs(outs["local"] - outs["mesh"]).max() <= tol
