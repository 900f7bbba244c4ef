"""Batched multi-stream decode: the framework's throughput path.

The ACM driver handles one stream per instance (AC3ACM.cpp:92-102); here N
streams of a common format are a leading batch axis, vmapped through the
per-stream block scan and sharded across the mesh's 'data' axis (jit
with NamedSharding).  An optional 'model' axis tensor-parallelizes the
filterbank contraction with an explicit psum (shard_map), for
configurations where a single stream batch spans devices.

Per-stream carried state (OLA delay planes + downmixed flag) is the
checkpoint/resume unit: a plain pytree, serializable with orbax or numpy.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache, partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

from .. import tables as T
from ..models.decoder import (StreamFormat, _pipeline_body, _pipeline_steady,
                              steady_ok)
from ..ops.filterbank import convert_to_int16


def _expand_compact(blocks):
    """Reconstruct f32 premixed planes from block-float H2D form inside
    the jitted body: freq = man(int16) * scale(f32 per block, plane,
    16-bin group).  The compact form halves host->device bytes (the e2e
    bottleneck on slow links); XLA fuses the rescale into the first
    consumer."""
    if "freq_man" not in blocks:
        return blocks
    out = {k: v for k, v in blocks.items()
           if k not in ("freq_man", "freq_scale")}
    man, scale = blocks["freq_man"], blocks["freq_scale"]
    g = scale.shape[-1]
    grouped = man.reshape(man.shape[:-1] + (g, 256 // g))
    freq = grouped.astype(jnp.float32) * scale[..., None]
    out["freq"] = freq.reshape(man.shape)
    return out


def batched_pipeline(fmt: StreamFormat, mesh=None, emit_int16: bool = False,
                     steady: bool = False, long_only: bool = False,
                     premixed: bool = False, exact: bool | None = None):
    """Returns jitted fn: (carry, blocks) -> (carry, pcm).

    carry: (delay [B,6,128] f32, downmixed [B] bool)
    blocks: pytree with leading [B, nblk, ...] axes.
    pcm: [B, nblk, nch_out, 256] float32 (or int16 when emit_int16).

    steady=True selects the scan-free fast body (bit-identical on chunks
    that pass models.decoder.steady_ok -- dispatch per call on the host);
    long_only=True additionally skips the short-block matmul (valid when
    no block in the chunk is short -- also host-checked).

    exact (default: the package ACCURACY policy, models.decoder.ACCURACY)
    selects the order-exact filterbank bodies -- bit-identical to the
    reference float build, the compare.c contract by construction.
    exact=False (ACCURACY="fast") selects the HIGHEST-precision matmul
    bodies.
    """
    from ..models.decoder import default_exact
    if exact is None:
        exact = default_exact()
    return _pipeline_cached(fmt, mesh, emit_int16, steady, long_only,
                            premixed, bool(exact))


@lru_cache(maxsize=64)
def _pipeline_cached(fmt: StreamFormat, mesh, emit_int16: bool,
                     steady: bool, long_only: bool, premixed: bool,
                     exact: bool = False):
    if steady:
        body = partial(_pipeline_steady, long_only=long_only,
                       premixed=premixed, exact=exact)
    else:
        body = partial(_pipeline_body, exact=exact)

    def run(carry, blocks):
        blocks = _expand_compact(blocks)
        carry, pcm = jax.vmap(partial(body, fmt))(carry, blocks)
        if emit_int16:
            pcm = convert_to_int16(pcm)
        return carry, pcm

    if mesh is None:
        return jax.jit(run)
    shard = NamedSharding(mesh, P("data"))
    return jax.jit(run, in_shardings=(shard, shard), out_shardings=(shard, shard))


def raw_batched_pipeline(fmt: StreamFormat, mesh=None,
                         emit_int16: bool = False, steady: bool = False,
                         long_only: bool = False, cpl_fc: int = -1,
                         exp_pts: int = 6, alloc_pts: int = 6,
                         exact: bool | None = None, emax: int = 256):
    """Raw-H2D decode: jitted (carry, frames_u8, meta, bias) -> (carry, pcm).

    The host ships raw AC-3 frame bytes [B, F, MB] plus per-block side-
    info meta [B, 6F, ...]; the device unpacks exponents, re-runs bit
    allocation, dequantizes mantissas (ops.unpack_device) and decodes --
    everything after the side-info parse runs on chip, and H2D volume is
    the coded ES itself (~1.8 KB/frame at 448 kbps vs 12.3 KB of f32
    premixed planes).  carry = (unpack carry dict, (delay, downmixed)).

    exact (default: the package ACCURACY policy) selects the order-exact
    decode tail."""
    from ..models.decoder import default_exact
    if exact is None:
        exact = default_exact()
    return _raw_pipeline_cached(fmt, mesh, emit_int16, steady, long_only,
                                cpl_fc, exp_pts, alloc_pts, bool(exact),
                                emax)


@lru_cache(maxsize=32)
def _raw_pipeline_cached(fmt: StreamFormat, mesh, emit_int16: bool,
                         steady: bool, long_only: bool, cpl_fc: int,
                         exp_pts: int = 6, alloc_pts: int = 6,
                         exact: bool = False, emax: int = 256):
    from ..ops.unpack_device import unpack_blocks as _ub
    unpack_blocks = partial(_ub, exp_pts=exp_pts, alloc_pts=alloc_pts,
                            emax=emax)

    if steady:
        body = partial(_pipeline_steady, long_only=long_only,
                       premixed=False, exact=exact)
    else:
        body = partial(_pipeline_body, exact=exact)

    def run(carry, frames_u8, meta, bias):
        ucarry, dcarry = carry
        ucarry, blocks = unpack_blocks(frames_u8, meta, ucarry, bias,
                                       nfch=fmt.nfchans, cpl_fc=cpl_fc)
        dcarry, pcm = jax.vmap(partial(body, fmt))(dcarry, blocks)
        if emit_int16:
            pcm = convert_to_int16(pcm)
        return (ucarry, dcarry), pcm

    if mesh is None:
        return jax.jit(run)
    shard = NamedSharding(mesh, P("data"))
    return jax.jit(run, in_shardings=(shard, shard, shard, shard),
                   out_shardings=(shard, shard))


def init_batched_carry(batch: int, mesh=None):
    delay = jnp.zeros((batch, 6, 128), jnp.float32)
    downmixed = jnp.ones((batch,), bool)
    if mesh is not None:
        shard = NamedSharding(mesh, P("data"))
        delay = jax.device_put(delay, shard)
        downmixed = jax.device_put(downmixed, shard)
    return delay, downmixed


# ---------------------------------------------------------------------------
# Tensor-parallel filterbank step (shard_map + psum) for the multi-chip
# transcode configuration: frequency contraction split over 'model'.
# ---------------------------------------------------------------------------

def tp_filterbank(mesh, coeffs, delay, blksw, bias):
    """coeffs [..., 256] sharded on last axis over 'model'; explicit psum.

    Demonstrates the collective layout for the 1024-stream transcode config
    (BASELINE.json config 5): each 'model' shard holds 256/m frequency rows
    of the IMDCT matrices, computes a partial [..., 384] product, and a
    psum over 'model' reduces to the full time-domain signal.
    """
    from ..ops.filterbank import _mats

    w_long, w_short, win = _mats()
    m = mesh.shape["model"]

    def step(c_shard, delay_full, blksw_full, bias_full):
        # c_shard: [..., 256//m]; local slice of the contraction axis
        idx = jax.lax.axis_index("model")
        rows = 256 // m
        wl = jax.lax.dynamic_slice_in_dim(jnp.asarray(w_long), idx * rows, rows, 0)
        ws = jax.lax.dynamic_slice_in_dim(jnp.asarray(w_short), idx * rows, rows, 0)
        blk = blksw_full[..., None]
        cl = jnp.where(blk, 0.0, c_shard)
        cs = jnp.where(blk, c_shard, 0.0)
        partial_zd = (jnp.matmul(cl, wl, precision=jax.lax.Precision.HIGHEST)
                      + jnp.matmul(cs, ws, precision=jax.lax.Precision.HIGHEST))
        zd = jax.lax.psum(partial_zd, "model")
        z, dnew = zd[..., :256], zd[..., 256:]
        wv = jnp.asarray(win)
        dfold = jnp.concatenate([delay_full, delay_full[..., ::-1]], axis=-1)
        out = z * wv + dfold * wv[::-1] + bias_full[..., None]
        return out, dnew

    return jax.shard_map(
        step, mesh=mesh,
        in_specs=(P("data", None, "model"), P("data", None, None),
                  P("data", None), P("data", None)),
        out_specs=(P("data", None, None), P("data", None, None)),
    )(coeffs, delay, blksw, bias)


# ---------------------------------------------------------------------------
# Host-side pool: N parsers feeding the batched device pipeline
# ---------------------------------------------------------------------------

@dataclass
class StreamLane:
    parser: object
    buf: bytes = b""
    pos: int = 0
    ok: bool = True          # failure-detection lane mask
    # parsed-but-not-yet-emitted FrameData (uneven lane feeds leave a
    # remainder here; the next decode_available resumes with it instead
    # of dropping consumed frames)
    pending: list = None

    def __post_init__(self):
        if self.pending is None:
            self.pending = []


class BatchedDecoder:
    """N same-format streams -> batched PCM.

    The host half runs on the native dense parser by default: one ctypes
    call parses every lane (C++ threads, GIL released) and emits
    device-ready tensors -- dequantized frequency planes, premixed output
    planes when the chunk qualifies for the steady path.  parser="python"
    selects the pure-Python host pass (same outputs, cross-checked in
    tests).

    Per-stream failure handling follows the reference's resync strategy
    (a52dec.c:271-306): a bad frame marks the lane invalid for that frame
    (its PCM is zeroed) instead of failing the batch.
    """

    def __init__(self, batch: int, flags: int, level: float = 1.0,
                 bias: float = 0.0, mesh=None, emit_int16: bool = False,
                 parser: str = "python", nthreads=None,
                 compact_h2d: bool = False):
        from ..host.parse import A52Parser
        sideinfo = parser == "raw_py"
        self.lanes = [StreamLane(parser=A52Parser(sideinfo_only=sideinfo))
                      for _ in range(batch)]
        self.flags = flags
        self.level = level
        self.bias = bias
        self.mesh = mesh
        self.emit_int16 = emit_int16
        # block-float premixed planes over the link (native parser only):
        # int16 mantissa + per-(block, plane) scale, ~2x fewer H2D bytes;
        # output drifts <= 1 int16 LSB vs the f32 planes (gated in
        # tests/test_native_decoder.py::test_compact_h2d)
        self.compact_h2d = compact_h2d and parser == "native"
        self._fmt = None
        self._fn = None
        self._carry = init_batched_carry(batch, mesh)
        self._parser_kind = parser
        self._dense = None
        self._pre_planes = None
        self._raw_carry = None           # unpack carry (raw-H2D mode)
        self._sdense = None              # native side-info pool (raw mode)
        if parser == "native":
            from ..host.native import DenseBatchParser
            self._dense = DenseBatchParser(batch, nthreads)
        elif parser == "raw":
            from ..host.native import SideinfoBatchParser
            self._sdense = SideinfoBatchParser(batch, nthreads)

    def feed(self, lane: int, data: bytes):
        ln = self.lanes[lane]
        ln.buf += data
        if ln.pos > (1 << 20):               # bounded-memory compaction
            ln.buf = ln.buf[ln.pos:]
            ln.pos = 0

    def _next_frame(self, lane: StreamLane):
        from ..host.parse import syncinfo
        buf, pos = lane.buf, lane.pos
        while pos + 7 <= len(buf):
            size, _, _, _ = syncinfo(buf[pos:pos + 7])
            if size == 0:
                pos += 1
                continue
            if pos + size > len(buf):
                break
            frame = buf[pos:pos + size]
            lane.pos = pos + size
            return frame
        lane.pos = pos
        return None

    def decode_available(self, max_frames: int = 8):
        """Parse up to max_frames per lane, run the device pipeline once.

        Returns (pcm [B, nblk, nch, 256], valid [B, nframes] bool) or None
        if no lane had a complete frame.
        """
        if self._dense is not None:
            return self._decode_available_native(max_frames)
        if self._sdense is not None:
            return self._decode_available_raw_native(max_frames)
        if self._parser_kind == "raw_py":
            return self._decode_available_raw(max_frames)
        from ..models.decoder import _stack_blocks
        for lane in self.lanes:
            while len(lane.pending) < max_frames:
                fb = self._next_frame(lane)
                if fb is None:
                    break
                try:
                    lane.pending.append(self.parser_decode(lane, fb))
                except Exception:
                    lane.pending.append(None)  # bad frame: masked lane-frame
        nf = min((len(l.pending) for l in self.lanes), default=0)
        if nf == 0:
            return None
        per_lane = [lane.pending[:nf] for lane in self.lanes]
        for lane in self.lanes:
            del lane.pending[:nf]
        valid = np.ones((len(self.lanes), nf), bool)
        for li, frames in enumerate(per_lane):
            for fi, f in enumerate(frames):
                if f is None:
                    valid[li, fi] = False

        # heterogeneous lanes (different acmod/output per lane, or a
        # mid-stream format change): bucket by StreamFormat
        fmts = {self._fmt_of(f) for row in per_lane for f in row
                if f is not None}
        if len(fmts) > 1:
            return self._decode_heterogeneous(per_lane, valid)

        stacked = []
        first = None                 # first valid FrameData in the batch
        for li, frames in enumerate(per_lane):
            fixed = []
            for fi, f in enumerate(frames):
                if f is None:
                    fixed.append(self._empty_frame())
                else:
                    if first is None:
                        first = f
                    fixed.append(f)
            stacked.append(_stack_blocks(fixed))
        blocks = jax.tree.map(lambda *xs: np.stack(xs), *stacked)

        # format from the frames actually being emitted (the live parser
        # state may already be ahead, on pending frames kept for later)
        if first is not None:
            fmt = StreamFormat(acmod=first.acmod, output=first.output,
                               slev_zero=bool(first.slev == 0.0),
                               chanbias=int(first.blocks[0].chanbias))
        else:
            s = self.lanes[0].parser.s
            from ..host.parse import downmix_coeff
            fmt = StreamFormat(acmod=s.acmod, output=s.output,
                               slev_zero=bool(s.slev == 0.0),
                               chanbias=int(downmix_coeff(
                                   s.acmod, s.output, 1.0, s.clev, s.slev)[1]))
        if steady_ok(fmt, blocks):
            from ..models.decoder import premix_blocks
            lo = not np.asarray(blocks["blksw"]).any()
            pre = fmt.nf_out < fmt.nfchans or fmt.identity_mix
            if pre:
                blocks = premix_blocks(fmt, blocks)
            fn = batched_pipeline(fmt, self.mesh, self.emit_int16,
                                  steady=True, long_only=lo, premixed=pre)
        else:
            fn = batched_pipeline(fmt, self.mesh, self.emit_int16)
        self._fmt = fmt
        self._carry, pcm = fn(self._carry, blocks)
        return pcm, valid

    # -- raw-H2D path (device bitstream unpack) -----------------------------

    def _parse_raw(self, lane: StreamLane, fb: bytes):
        """Side-info-only parse of one frame -> (bytes, recs[6], fmt),
        or None for a malformed frame (masked lane-frame)."""
        p = lane.parser
        p.rec.clear()
        try:
            br, _ = p.frame(fb, self.flags, self.level, self.bias)
            for _ in range(T.NB_BLOCKS):
                p._block(br)
            recs = list(p.rec)
            p.rec.clear()
            if len(recs) != T.NB_BLOCKS:
                return None
            r0 = recs[0]
            fmt = StreamFormat(acmod=int(r0["acmod"]),
                               output=int(r0["output"]),
                               slev_zero=bool(r0["slev_zero"]),
                               chanbias=int(r0["chanbias"]))
            return fb, recs, fmt
        except Exception:
            p.rec.clear()
            return None

    def _decode_available_raw(self, max_frames: int):
        """Raw-H2D decode step: ship frame bytes + side-info meta, unpack
        and decode everything else on device (raw_batched_pipeline)."""
        from ..ops.unpack_device import (init_unpack_carry, null_raw_rec,
                                         stack_raw_meta)
        for lane in self.lanes:
            while len(lane.pending) < max_frames:
                fb = self._next_frame(lane)
                if fb is None:
                    break
                lane.pending.append(self._parse_raw(lane, fb))
        nf = min((len(l.pending) for l in self.lanes), default=0)
        if nf == 0:
            return None
        per_lane = [lane.pending[:nf] for lane in self.lanes]
        for lane in self.lanes:
            del lane.pending[:nf]
        L = len(self.lanes)
        valid = np.array([[f is not None for f in row] for row in per_lane])

        fmt = self._raw_pick_fmt(
            {f[2] for row in per_lane for f in row if f is not None})

        mb = max((len(f[0]) for row in per_lane for f in row
                  if f is not None), default=128)
        mb = -(-mb // 128) * 128
        fu8 = np.zeros((L, nf, mb), np.uint8)
        null6 = [null_raw_rec()] * T.NB_BLOCKS
        metas = []
        for li, row in enumerate(per_lane):
            recs = []
            for fi, f in enumerate(row):
                if f is None:
                    recs.extend(null6)
                else:
                    fu8[li, fi, :len(f[0])] = np.frombuffer(f[0], np.uint8)
                    recs.extend(f[1])
            metas.append(stack_raw_meta(recs))
        meta = {k: np.stack([m[k] for m in metas]) for k in metas[0]
                if k != "raw_ok"}
        return self._raw_dispatch(fmt, fu8, meta, valid)

    def _raw_dispatch(self, fmt, fu8, meta, valid):
        """Shared tail of the raw-H2D paths: ship frame bytes + meta,
        unpack and decode on device."""
        from ..ops.unpack_device import (init_unpack_carry, prune_raw_meta,
                                         static_alloc_pts, static_cpl_fc,
                                         static_emax, static_exp_pts)
        L, nf = fu8.shape[:2]
        # drop meta keys for features absent from the whole chunk (delta
        # bit allocation, coupling, dither, LFE): the jit specializes on
        # the pytree structure, picking a program with fewer rows, a
        # smaller mantissa lattice and no coupling/dither stages -- and
        # the dropped tensors never cross the host link
        meta = prune_raw_meta(meta)

        steady = steady_ok(fmt, {"blksw": meta["blksw"].astype(bool),
                                 "coeff": meta["coeff"]})
        lo = steady and not meta["blksw"].any()
        if self._raw_carry is None:
            self._raw_carry = init_unpack_carry(L, self.mesh)
        bias = np.full((L, T.NB_BLOCKS * nf), self.bias, np.float32)
        # The probed point counts are jit cache keys.  Heterogeneous
        # content whose per-chunk counts wander (transient-heavy encodes
        # flipping 1 <-> 3 exponent points) would recompile per distinct
        # value and thrash the program cache, so quantize to a small
        # ladder and keep a running max per stream run (a larger count
        # is always correct -- extra points pad out).
        ladder = (1, 2, 3, 6)
        ep = min(x for x in ladder if x >= static_exp_pts(meta))
        ap = min(x for x in ladder if x >= static_alloc_pts(meta))
        self._exp_pts = ep = max(ep, getattr(self, "_exp_pts", 1))
        self._alloc_pts = ap = max(ap, getattr(self, "_alloc_pts", 1))
        # mantissa-gather trim extent: like the point counts, laddered
        # and carried as a running max so it never shrinks mid-stream
        self._emax = em = max(static_emax(meta),
                              getattr(self, "_emax", 128))
        fn = raw_batched_pipeline(fmt, self.mesh, self.emit_int16,
                                  steady=steady, long_only=lo,
                                  cpl_fc=static_cpl_fc(meta),
                                  exp_pts=ep, alloc_pts=ap, emax=em)
        self._fmt = fmt
        carry = (self._raw_carry, self._carry)
        (self._raw_carry, self._carry), pcm = fn(carry, fu8, meta, bias)
        return pcm, valid

    def _raw_pick_fmt(self, fmts: set):
        if len(fmts) > 1:
            raise ValueError(
                "raw-H2D mode requires a format-homogeneous batch; use "
                "parser='python' or 'native' for mixed-format lanes")
        if fmts:
            return fmts.pop()
        if self._fmt is not None:
            return self._fmt
        out = self.flags & T.A52_CHANNEL_MASK
        return StreamFormat(acmod=out, output=out, slev_zero=True,
                            chanbias=0)

    def _decode_available_raw_native(self, max_frames: int):
        """Raw-H2D decode with the native side-info pool: one ctypes call
        parses every lane (C++ threads, GIL released) and emits frame
        bytes + RawRecWire side-info; the device does the rest."""
        L = len(self.lanes)
        need = max_frames - min(len(l.pending) for l in self.lanes)
        if need > 0:
            r = self._sdense.parse([(l.buf, l.pos) for l in self.lanes],
                                   need, self.flags, self.level, self.bias)
            for i, lane in enumerate(self.lanes):
                lane.pos += int(r["consumed"][i])
                for f in range(int(r["nframes"][i])):
                    ok = bool(r["valid"][i, f])
                    fmt = None
                    if ok and r["fmt"][i, f, 3]:
                        fmt = StreamFormat(
                            acmod=int(r["fmt"][i, f, 0]),
                            output=int(r["fmt"][i, f, 1]),
                            slev_zero=bool(r["fmt"][i, f, 2]),
                            chanbias=int(r["recs"][i, 6 * f]["chanbias"]))
                    lane.pending.append(
                        (r["frames"][i, f],
                         int(r["fsizes"][i, f]) if ok else 0,
                         r["recs"][i, 6 * f: 6 * f + 6], fmt))
        nf = min((len(l.pending) for l in self.lanes), default=0)
        if nf == 0:
            return None
        per_lane = [lane.pending[:nf] for lane in self.lanes]
        for lane in self.lanes:
            del lane.pending[:nf]
        valid = np.array([[f[3] is not None for f in row]
                          for row in per_lane])
        fmt = self._raw_pick_fmt(
            {f[3] for row in per_lane for f in row if f[3] is not None})
        mb = max((f[1] for row in per_lane for f in row), default=128)
        mb = max(-(-mb // 128) * 128, 128)
        fu8 = np.zeros((L, nf, mb), np.uint8)
        for li, row in enumerate(per_lane):
            for fi, f in enumerate(row):
                fu8[li, fi] = f[0][:mb]
        recs = np.stack([np.concatenate([f[2] for f in row])
                         for row in per_lane])             # [L, S] structured
        meta = {k: np.ascontiguousarray(recs[k]) for k in recs.dtype.names}
        return self._raw_dispatch(fmt, fu8, meta, valid)

    # -- native dense-parser path -------------------------------------------

    def _expected_pre_planes(self):
        """Output-plane count for the premixed steady path, derived from the
        next frame header + requested flags.  clev/slev only affect the
        STEREO<->DOLBY promotion, which has the same plane count, so zeros
        suffice for the negotiation here."""
        from ..host.parse import downmix_init, syncinfo
        for lane in self.lanes:
            buf, pos = lane.buf, lane.pos
            while pos + 7 <= len(buf):
                size, sflags, _, _ = syncinfo(buf[pos:pos + 7])
                if size == 0:
                    pos += 1
                    continue
                acmod_in = sflags & T.A52_CHANNEL_MASK
                out, _ = downmix_init(acmod_in, self.flags, 1.0,
                                      np.float32(0.0), np.float32(0.0))
                if out < 0:
                    return 0
                outm = out & T.A52_CHANNEL_MASK
                nf_out = int(T.NFCHANS[outm])
                lfe = 1 if (sflags & T.A52_LFE) and (self.flags & T.A52_LFE) \
                    else 0
                if nf_out < int(T.NFCHANS[acmod_in]):
                    return nf_out + lfe      # reducing mix (freq path)
                if nf_out == int(T.NFCHANS[acmod_in]) and (
                        outm == acmod_in or
                        (acmod_in == T.A52_STEREO and outm == T.A52_DOLBY)):
                    # identity-mix passthrough (chanbias is always 0 for
                    # these pairs): premix = rematrix only
                    return nf_out + lfe
                return 0                     # upmix / non-identity: no premix
        return None                          # no header yet; retry later

    @staticmethod
    def _frame_slice(r, lane: int, f: int) -> dict:
        s = slice(f * 6, f * 6 + 6)
        return {
            "freq_full": r["freq_full"][lane, s],
            "freq_pre": None if r["freq_pre"] is None
            else r["freq_pre"][lane, s],
            "freq_man": None if r.get("freq_man") is None
            else r["freq_man"][lane, s],
            "freq_scale": None if r.get("freq_scale") is None
            else r["freq_scale"][lane, s],
            "blksw": r["blksw"][lane, s],
            "coeff": r["coeff"][lane, s],
            "remat": r["remat"][lane, s],
            "bias": r["bias"][lane, s],
            "valid": bool(r["valid"][lane, f]),
            "premix_ok": bool(r["premix_ok"][lane, f]),
            "meta": (r["meta"][lane, f].copy()
                     if r["meta"][lane, f, 6] else None),
        }

    def _fmt_from_meta(self, meta):
        if meta is not None:
            return StreamFormat(acmod=int(meta[0]), output=int(meta[2]),
                                slev_zero=bool(meta[5]),
                                chanbias=int(meta[4]))
        if self._fmt is not None:
            return self._fmt
        out = self.flags & T.A52_CHANNEL_MASK
        return StreamFormat(acmod=out, output=out, slev_zero=True, chanbias=0)

    def _run_native(self, fmt, valid, freq_pre, freq_full, blksw, coeff,
                    remat, bias, premix_all, freq_man=None, freq_scale=None):
        blksw = np.ascontiguousarray(blksw).astype(bool)
        bias = np.ascontiguousarray(bias)
        if premix_all:
            if freq_man is not None:
                blocks = {"freq_man": np.ascontiguousarray(freq_man),
                          "freq_scale": np.ascontiguousarray(freq_scale),
                          "blksw": blksw, "bias": bias}
            else:
                blocks = {"freq": np.ascontiguousarray(freq_pre),
                          "blksw": blksw, "bias": bias}
            lo = not blksw.any()
            fn = batched_pipeline(fmt, self.mesh, self.emit_int16,
                                  steady=True, long_only=lo, premixed=True)
        else:
            blocks = {"freq": np.ascontiguousarray(freq_full),
                      "blksw": blksw,
                      "coeff": np.ascontiguousarray(coeff),
                      "remat": np.ascontiguousarray(remat).astype(bool),
                      "bias": bias}
            steady = steady_ok(fmt, blocks)
            lo = steady and not blksw.any()
            fn = batched_pipeline(fmt, self.mesh, self.emit_int16,
                                  steady=steady, long_only=lo)
        self._fmt = fmt
        self._carry, pcm = fn(self._carry, blocks)
        return pcm, valid

    def _decode_available_native(self, max_frames: int):
        if self._pre_planes is None:
            self._pre_planes = self._expected_pre_planes()
        pp = self._pre_planes or 0
        had_pending = any(l.pending for l in self.lanes)
        need = max_frames - min(len(l.pending) for l in self.lanes)
        r = None
        if need > 0:
            r = self._dense.parse([(l.buf, l.pos) for l in self.lanes],
                                  need, self.flags, self.level, self.bias,
                                  pp, compact=self.compact_h2d)
            for i, lane in enumerate(self.lanes):
                lane.pos += int(r["consumed"][i])
        if r is not None and not had_pending:
            nfr = r["nframes"]
            nf = int(nfr.min())
            if nf > 0 and (nfr == nf).all():
                # heterogeneous lane formats -- across lanes OR mid-stream
                # within one lane's emitted frames: route through the
                # bucketed path (one masked batch call per distinct format)
                lane_fmts = {
                    self._fmt_from_meta(r["meta"][i, f])
                    for i in range(len(self.lanes)) for f in range(nf)
                    if r["meta"][i, f, 6]}
                if len(lane_fmts) > 1:
                    emit = [[self._frame_slice(r, i, f) for f in range(nf)]
                            for i in range(len(self.lanes))]
                    valid = r["valid"][:, :nf].astype(bool)
                    return self._decode_heterogeneous(emit, valid)
                # fast path: the parse output is already the batch
                rows = nf * 6
                fmt = (next(iter(lane_fmts)) if lane_fmts
                       else self._fmt_from_meta(None))
                valid = r["valid"][:, :nf].astype(bool)
                premix_all = (pp > 0
                              and (fmt.nf_out < fmt.nfchans
                                   or fmt.identity_mix)
                              and bool(r["premix_ok"][:, :nf].all()))
                compact = premix_all and r["freq_man"] is not None
                return self._run_native(
                    fmt, valid,
                    None if r["freq_pre"] is None else r["freq_pre"][:, :rows],
                    r["freq_full"][:, :rows], r["blksw"][:, :rows],
                    r["coeff"][:, :rows], r["remat"][:, :rows],
                    r["bias"][:, :rows], premix_all,
                    freq_man=r["freq_man"][:, :rows] if compact else None,
                    freq_scale=r["freq_scale"][:, :rows] if compact else None)
        if r is not None:
            for i, lane in enumerate(self.lanes):
                for f in range(int(r["nframes"][i])):
                    lane.pending.append(self._frame_slice(r, i, f))
        nf = min((len(l.pending) for l in self.lanes), default=0)
        if nf == 0:
            return None
        emit = [l.pending[:nf] for l in self.lanes]
        for lane in self.lanes:
            del lane.pending[:nf]
        valid = np.array([[fr["valid"] for fr in frames] for frames in emit])
        emit_fmts = {self._fmt_of(fr) for frames in emit for fr in frames
                     if fr["meta"] is not None}
        if len(emit_fmts) > 1:
            return self._decode_heterogeneous(emit, valid)
        meta = next((fr["meta"] for frames in emit for fr in frames
                     if fr["meta"] is not None), None)
        fmt = self._fmt_from_meta(meta)
        premix_all = (pp > 0
                      and (fmt.nf_out < fmt.nfchans or fmt.identity_mix)
                      and all(fr["premix_ok"] and fr["freq_pre"] is not None
                              for frames in emit for fr in frames))
        cat = lambda key: np.stack(
            [np.concatenate([fr[key] for fr in frames]) for frames in emit])
        compact = premix_all and all(
            fr.get("freq_man") is not None
            for frames in emit for fr in frames)
        return self._run_native(
            fmt, valid,
            cat("freq_pre") if premix_all and not compact else None,
            None if premix_all else cat("freq_full"),
            cat("blksw"), None if premix_all else cat("coeff"),
            None if premix_all else cat("remat"), cat("bias"), premix_all,
            freq_man=cat("freq_man") if compact else None,
            freq_scale=cat("freq_scale") if compact else None)

    # -- heterogeneous-lane bucketing ---------------------------------------

    @staticmethod
    def _fmt_of(obj):
        """StreamFormat of a pending entry: FrameData (python parser) or a
        native _frame_slice dict."""
        if isinstance(obj, dict):
            m = obj["meta"]
            if m is None:
                return None
            return StreamFormat(acmod=int(m[0]), output=int(m[2]),
                                slev_zero=bool(m[5]), chanbias=int(m[4]))
        return StreamFormat(acmod=obj.acmod, output=obj.output,
                            slev_zero=bool(obj.slev == 0.0),
                            chanbias=int(obj.blocks[0].chanbias))

    def _generic_blocks(self, obj):
        """Pipeline-generic [6, ...] block tensors for one frame."""
        from ..models.decoder import _stack_blocks
        if isinstance(obj, dict):
            return {"freq": obj["freq_full"], "blksw": obj["blksw"],
                    "coeff": obj["coeff"],
                    "remat": obj["remat"].astype(bool), "bias": obj["bias"]}
        return _stack_blocks([obj])

    @staticmethod
    def _premixed_frame(obj, fmt):
        """Premixed [6, nch_out, 256] block tensors for one native frame
        slice, or None when the frame doesn't carry a valid premix (python-
        parser FrameData, premix-ineligible frame, or plane-count mismatch
        after a format change)."""
        if not isinstance(obj, dict) or not obj.get("premix_ok"):
            return None
        fp = obj.get("freq_pre")
        if fp is None or fp.shape[-2] != fmt.nch_out:
            return None
        return {"freq": fp, "blksw": obj["blksw"], "bias": obj["bias"]}

    def _bucket_size(self, nsel: int) -> int:
        """Static sub-batch sizes: next power of two (compile ladder of
        log2(B) sizes per format), rounded up to a multiple of the mesh's
        device count so sharded buckets stay evenly divisible."""
        B = len(self.lanes)
        b = 1
        while b < nsel:
            b <<= 1
        if self.mesh is not None:
            nd = int(np.prod([self.mesh.shape[a] for a in
                              self.mesh.axis_names]))
            b = max(b, nd)
            if b % nd:
                b = ((b + nd - 1) // nd) * nd
        return min(b, max(B, 1)) if b <= B else b

    def _decode_heterogeneous(self, per_lane, valid):
        """Bucket lanes by per-frame StreamFormat (SURVEY hard-part 4).

        Lanes are COMPACTED into per-format sub-batches padded to a small
        static-size ladder (powers of two), so the device cost of a mixed
        batch is ~the sum of bucket costs instead of formats x full-batch
        (VERDICT r2 #7).  Each bucket re-checks the steady/premixed fast
        path, so a format flip in one lane no longer drops every lane to
        the scan body.  Lanes may change format mid-stream; the OLA carry
        persists across the change exactly like the reference's single
        a52_state_t.
        """
        from ..models.decoder import premix_blocks, steady_ok
        B = len(self.lanes)
        nf = len(per_lane[0])
        fall = self._fmt
        fmts = []
        for row in per_lane:
            lane_fmts = []
            prev = fall
            for f in row:
                cur = self._fmt_of(f) if f is not None else None
                if cur is None:
                    cur = prev or next(
                        (self._fmt_of(g) for r2 in per_lane for g in r2
                         if g is not None and self._fmt_of(g) is not None))
                lane_fmts.append(cur)
                prev = cur
            fmts.append(lane_fmts)
        nch_max = max(f.nch_out for row in fmts for f in row)
        dtype = np.int16 if self.emit_int16 else np.float32
        # the whole frame x bucket loop runs WITHOUT a device sync: carries
        # are gathered/scattered by index on device, bucket PCM lands in a
        # device output buffer, and the single fetch at the end drains the
        # queued work (with a mesh the carry stays host-side: the
        # resharding gathers aren't worth it for that rare combination)
        on_device = self.mesh is None
        out = (jnp.zeros((B, nf * 6, nch_max, 256), dtype) if on_device
               else np.zeros((B, nf * 6, nch_max, 256), dtype))
        empty = {
            "freq": np.zeros((6, 6, 256), np.float32),
            "blksw": np.zeros((6, 5), bool),
            "coeff": np.zeros((6, 5), np.float32),
            "remat": np.zeros((6, 256), bool),
            "bias": np.full((6,), np.float32(self.bias)),
        }
        d_all = (jnp.asarray(self._carry[0]) if on_device
                 else np.array(self._carry[0]))
        m_all = (jnp.asarray(self._carry[1]) if on_device
                 else np.array(self._carry[1]))
        seg0 = 0
        while seg0 < nf:
            # segment = maximal run of frames with an identical per-lane
            # format assignment (the common case -- no mid-stream change --
            # is ONE segment): each bucket then dispatches once over all
            # the segment's frames instead of once per frame
            key = [fmts[li][seg0] for li in range(B)]
            seg1 = seg0 + 1
            while seg1 < nf and all(fmts[li][seg1] == key[li]
                                    for li in range(B)):
                seg1 += 1
            fr = range(seg0, seg1)
            ns = seg1 - seg0
            groups = {}
            for li in range(B):
                groups.setdefault(key[li], []).append(li)

            def catframes(frames):
                """Per-frame [6, ...] block dicts -> one [ns*6, ...] chunk."""
                if len(frames) == 1:
                    return frames[0]
                return jax.tree.map(lambda *xs: np.concatenate(xs), *frames)

            for fmt, sel in groups.items():
                bb = self._bucket_size(len(sel))
                # premixed bucket: every present frame carries a native
                # premix for this format (absent/invalid lanes use zero
                # planes, valid in either layout) -- the bucket then rides
                # the same premixed steady/fused dispatch as homogeneous
                # batches instead of re-shipping 6 full planes
                pres = [[self._premixed_frame(per_lane[li][fi], fmt)
                         if per_lane[li][fi] is not None else "zero"
                         for fi in fr] for li in sel]
                pre_eligible = ((fmt.nf_out < fmt.nfchans
                                 or fmt.identity_mix)
                                and all(p is not None
                                        for row in pres for p in row))
                if pre_eligible:
                    empty_pre = {
                        "freq": np.zeros((6, fmt.nch_out, 256), np.float32),
                        "blksw": np.zeros((6, 5), bool),
                        "bias": np.full((6,), np.float32(self.bias)),
                    }
                    rows = [catframes([empty_pre if p == "zero" else p
                                       for p in row]) for row in pres]
                    if bb > len(sel):
                        rows += [catframes([empty_pre] * ns)] \
                            * (bb - len(sel))
                else:
                    rows = [catframes(
                        [self._generic_blocks(per_lane[li][fi])
                         if per_lane[li][fi] is not None else empty
                         for fi in fr]) for li in sel]
                    if bb > len(sel):
                        rows += [catframes([empty] * ns)] * (bb - len(sel))
                blocks = jax.tree.map(lambda *xs: np.stack(xs), *rows)
                if on_device:
                    sel_arr = jnp.asarray(np.array(sel, np.int32))
                    pad = bb - len(sel)
                    dg, mg = d_all[sel_arr], m_all[sel_arr]
                    if pad:
                        dg = jnp.concatenate(
                            [dg, jnp.zeros((pad, 6, 128), jnp.float32)])
                        mg = jnp.concatenate(
                            [mg, jnp.ones((pad,), bool)])
                    carry = (dg, mg)
                else:
                    carry = (jnp.asarray(np.concatenate(
                                 [d_all[sel],
                                  np.zeros((bb - len(sel), 6, 128),
                                           np.float32)])),
                             jnp.asarray(np.concatenate(
                                 [m_all[sel],
                                  np.ones(bb - len(sel), bool)])))
                if pre_eligible:
                    lo = not np.asarray(blocks["blksw"]).any()
                    fn = batched_pipeline(fmt, self.mesh, self.emit_int16,
                                          steady=True, long_only=lo,
                                          premixed=True)
                elif steady_ok(fmt, blocks):
                    lo = not np.asarray(blocks["blksw"]).any()
                    pre = fmt.nf_out < fmt.nfchans or fmt.identity_mix
                    if pre:
                        blocks = premix_blocks(fmt, blocks)
                    fn = batched_pipeline(fmt, self.mesh, self.emit_int16,
                                          steady=True, long_only=lo,
                                          premixed=pre)
                else:
                    fn = batched_pipeline(fmt, self.mesh, self.emit_int16)
                carry2, pcm = fn(carry, blocks)
                if on_device:
                    d_all = d_all.at[sel_arr].set(carry2[0][:len(sel)])
                    m_all = m_all.at[sel_arr].set(carry2[1][:len(sel)])
                    out = out.at[sel_arr, seg0 * 6:seg1 * 6,
                                 :fmt.nch_out].set(
                        pcm[:len(sel)].astype(out.dtype))
                else:
                    d_all[sel] = np.asarray(carry2[0])[:len(sel)]
                    m_all[sel] = np.asarray(carry2[1])[:len(sel)]
                    out[sel, seg0 * 6:seg1 * 6, :fmt.nch_out] = \
                        np.asarray(pcm)[:len(sel)]
                self._fmt = fmt
            seg0 = seg1
        self._carry = ((d_all, m_all) if on_device
                       else (jnp.asarray(d_all), jnp.asarray(m_all)))
        # return the DEVICE buffer like the dense path does: consumers
        # pay the device->host transfer only when they read the PCM
        return out, valid

    def parser_decode(self, lane: StreamLane, frame: bytes):
        return lane.parser.decode_frame(frame, self.flags, self.level, self.bias)

    def _empty_frame(self):
        from ..host.parse import BlockData, FrameData
        z = np.zeros((6, 256), np.float32)
        blk = BlockData(q=z, a=z, b=z, blksw=np.zeros(5, bool),
                        coeff=np.zeros(5, np.float32), chanbias=0,
                        remat_mask=np.zeros(256, bool),
                        lfe_scale=np.float32(0))
        s = self.lanes[0].parser.s
        return FrameData(acmod=s.acmod, lfeon=s.lfeon, output=s.output,
                         nfchans=int(T.NFCHANS[s.acmod]), bias=np.float32(self.bias),
                         slev=s.slev, blocks=[blk] * 6)
