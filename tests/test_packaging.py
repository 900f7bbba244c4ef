"""Wheel/packaging smoke test (VERDICT r4 weak 3 / missing 2).

The reference ships installers (bin/x86/AC3ACM.inf:64-90 registers the
codec system-wide); this framework's distribution story is a pip wheel.
The wheel must carry the ENTIRE native bit-exact backend -- ac3host.cpp
plus the .inc files it #includes (ac3acm_tpu/native/, compiled on demand
by host/native.py) -- and work from a clean install location with the
repo checkout nowhere on the path.
"""
import os
import subprocess
import sys
import zipfile

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def wheel_path(tmp_path_factory):
    out = tmp_path_factory.mktemp("wheel")
    r = subprocess.run(
        [sys.executable, "-m", "pip", "wheel", "--no-deps",
         "--no-build-isolation", "-w", str(out), REPO],
        capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    wheels = [f for f in os.listdir(out) if f.endswith(".whl")]
    assert len(wheels) == 1, wheels
    return os.path.join(out, wheels[0])


def test_wheel_contains_native_backend(wheel_path):
    names = zipfile.ZipFile(wheel_path).namelist()
    for want in ("ac3acm_tpu/native/ac3host.cpp",
                 "ac3acm_tpu/native/ac3fb.inc",
                 "ac3acm_tpu/native/ac3sample.inc",
                 "ac3acm_tpu/host/native.py"):
        assert want in names, (want, [n for n in names if "native" in n])


def test_wheel_install_decodes_bit_exact(wheel_path, tmp_path):
    """Unpack the wheel into a clean prefix (a wheel IS an importable
    zip layout), then -- in a subprocess whose sys.path holds ONLY that
    prefix (repo checkout excluded) -- build the native backend from the
    shipped sources and decode the first golden frame.  The dequantized
    planes must be bit-identical to the same decode from the checkout."""
    prefix = tmp_path / "site"
    with zipfile.ZipFile(wheel_path) as z:
        z.extractall(prefix)

    gold = os.path.join(REPO, "tests", "golden", "bench_51_448.ac3")
    script = tmp_path / "drive.py"
    script.write_text(
        "import sys\n"
        "import numpy as np\n"
        f"sys.path.insert(0, {str(prefix)!r})\n"
        "import ac3acm_tpu\n"
        f"assert ac3acm_tpu.__file__.startswith({str(prefix)!r}), "
        "ac3acm_tpu.__file__\n"
        "from ac3acm_tpu.host.native import NativeParser\n"
        "import ac3acm_tpu.tables as T\n"
        f"es = open({gold!r}, 'rb').read()\n"
        "blocks, meta = NativeParser().decode_frames(\n"
        "    es, 2, T.A52_STEREO | T.A52_ADJUST_LEVEL, 1.0, 0.0)\n"
        f"np.save({str(tmp_path / 'wheel_freq.npy')!r}, blocks['freq'])\n"
        "print('WHEEL_DECODE_OK')\n")
    env = dict(os.environ)
    env["AC3ACM_NATIVE_BUILD_DIR"] = str(tmp_path / "nbuild")
    # keep the repo out of the subprocess path entirely
    env.pop("PYTHONPATH", None)
    r = subprocess.run([sys.executable, str(script)], capture_output=True,
                       text=True, timeout=300, cwd=str(tmp_path), env=env)
    assert r.returncode == 0 and "WHEEL_DECODE_OK" in r.stdout, \
        (r.stdout[-500:], r.stderr[-3000:])

    from ac3acm_tpu.host.native import NativeParser
    import ac3acm_tpu.tables as T
    es = open(gold, "rb").read()
    blocks, meta = NativeParser().decode_frames(
        es, 2, T.A52_STEREO | T.A52_ADJUST_LEVEL, 1.0, 0.0)
    got = np.load(tmp_path / "wheel_freq.npy")
    np.testing.assert_array_equal(got, blocks["freq"])
