"""chip_smoke.py: its GPU gate and its phases at small size.

The CPU tests run the phase functions themselves (the script's main()
refuses any backend but the GPU); the `gpu`-marked tests run the same
phases on the card and skip elsewhere:

    JAX_PLATFORMS=cuda python -m pytest tests/test_chip_smoke.py -m gpu
"""
import json
import os
import subprocess
import sys

import pytest

import chip_smoke as cs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_chip_smoke_refuses_cpu():
    """No GPU: exit non-zero before any phase, and print no result."""
    with pytest.raises(SystemExit):
        cs.require_gpu()
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    for line in r.stdout.splitlines():
        with pytest.raises(ValueError):
            json.loads(line)


def test_chip_smoke_decode_and_raw_phases_small():
    """Phases 2 and 3 at 16 lanes x 2 chunks of 2 frames: golden-oracle
    exact int16, equal lanes agree, raw-H2D bit-identical to native."""
    pcm = cs.phase_decode(lanes=16, chunk=2, nchunks=2)
    assert pcm.shape == (16, 24, 2, 256)
    cs.phase_raw(pcm, chunk=2, nchunks=2)


def test_chip_smoke_encode_phase_small():
    cs.phase_encode(lanes=2)


def test_chip_smoke_transcode_phase_small():
    cs.phase_transcode(lanes=8, chunk=2, nchunks=2)


@pytest.mark.gpu
def test_gpu_decode_and_raw_phases():
    pcm = cs.phase_decode(lanes=256, chunk=4, nchunks=2)
    cs.phase_raw(pcm, chunk=4, nchunks=2)


@pytest.mark.gpu
def test_gpu_golden_phase():
    assert cs.phase_golden() > 0


@pytest.mark.gpu
def test_gpu_encode_phase():
    cs.phase_encode()


@pytest.mark.gpu
def test_gpu_transcode_phase():
    cs.phase_transcode(lanes=64, chunk=4, nchunks=2)
