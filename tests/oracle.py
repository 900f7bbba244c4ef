"""Oracles the repository carries, shared by the tests and chip_smoke.py:
the PCM generators behind the committed reference-encoded streams (so the
encoder's output can be checked byte for byte against them without the
reference checkout) and the reference's compare.c error measures."""
import numpy as np


def make_pcm(nch, nframes, seed=0, kind="music"):
    rng = np.random.default_rng(seed)
    n = nframes * 1536
    t = np.arange(n)[:, None]
    freqs = rng.uniform(30, 8000, size=(1, nch))
    phase = rng.uniform(0, 2 * np.pi, size=(1, nch))
    sig = 0.4 * np.sin(2 * np.pi * freqs * t / 48000 + phase)
    sig += 0.3 * np.sin(2 * np.pi * freqs * 3.1 * t / 48000)
    sig += 0.05 * rng.standard_normal((n, nch))
    env = np.minimum(1.0, np.abs(np.sin(2 * np.pi * t / 9000)) + 0.1)
    return np.clip(sig * env * 20000, -32767, 32767).astype(np.int16)


def compare_oracle(a, b):
    """test/compare.c thresholds, in 1/32768 full-scale units."""
    a = np.asarray(a, np.float64).ravel()
    b = np.asarray(b, np.float64).ravel()
    assert a.shape == b.shape
    d = a - b
    maxe = np.abs(d).max() * 32768
    mean = abs(d.mean()) * 32768
    var = (d * d).mean() - d.mean() ** 2
    std = 32768 * np.sqrt(max(var, 0))
    return maxe, mean, std


def loud_pcm(nch, nframes, seed):
    """Near-full-scale, channel-correlated content: a 2.0 downmix of these
    planes sums coherently and exceeds full scale without level adjust."""
    rng = np.random.default_rng(seed)
    n = nframes * 1536
    t = np.arange(n, dtype=np.float64)
    f0 = rng.uniform(80, 400)
    sig = (0.75 * np.sin(2 * np.pi * f0 * t / 48000)
           + 0.25 * np.sin(2 * np.pi * f0 * 2.97 * t / 48000))
    chans = [sig * (1.0 - 0.02 * i) for i in range(nch)]
    pcm = np.stack(chans, -1) * 31500.0
    return np.clip(pcm, -32767, 32767).astype(np.int16)


# reference-encoder streams: (name, nch, kbps, freq, nframes, seed, loud)
ENC_SPECS = [
    ("bench_51_448.ac3", 6, 448, 48000, 8, 77, False),
    ("stereo_192.ac3", 2, 192, 48000, 6, 42, False),
    ("mono_96.ac3", 1, 96, 48000, 4, 11, False),
    ("stereo441_128.ac3", 2, 128, 44100, 9, 123, False),
    ("s51_441_384.ac3", 6, 384, 44100, 6, 124, False),
    ("stereo32_96.ac3", 2, 96, 32000, 6, 125, False),
    ("halfrate24_64.ac3", 2, 64, 24000, 6, 126, False),
    ("quarterrate12_32.ac3", 1, 32, 12000, 5, 127, False),
    ("overdrive_51_448.ac3", 6, 448, 48000, 6, 128, True),
]


def enc_spec_pcm(spec):
    """The int16 PCM [n, nch] a committed ENC_SPECS stream was encoded
    from."""
    name, nch, kbps, freq, nfr, seed, loud = spec
    return loud_pcm(nch, nfr, seed) if loud else make_pcm(nch, nfr, seed=seed)
