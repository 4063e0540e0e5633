"""The port's reference-clip resampler keeps a tone's level and shape.

Every reference clip reaches the spectrogram at 32 kHz and HuBERT at
16 kHz through ``ops/audio.py::resample_poly`` (scipy's polyphase
filter, which the JAX package uses only where its native library cannot
be built). A 0.3-amplitude 440 Hz sine at the common recording rates
must keep its peak within 1% and stay within relative L2 1e-3 of the
true sine at the new rate, away from the filter's edge transients (the
first and last tenth). The JAX package's native ``ga_resample`` scales
such a sine by 2x (48 and 16 kHz -> 32 kHz) and 8x (44.1 kHz -> 32 kHz)
(ROADMAP Queue 3, item 6; scripts/native_resample_gain.py), so the port
keeps scipy and loads no native audio library on this path.
"""
import subprocess
import sys

import numpy as np
import pytest

from genie_tts_tpu_torch.ops.audio import resample_poly

AMP, FREQ = 0.3, 440.0


def _sine(sr, seconds=1.0):
    t = np.arange(int(sr * seconds)) / sr
    return (AMP * np.sin(2 * np.pi * FREQ * t)).astype(np.float32)


@pytest.mark.parametrize("sr_in,sr_out", [(48000, 32000), (44100, 32000),
                                          (16000, 32000), (32000, 16000)])
def test_resample_keeps_a_sine(sr_in, sr_out):
    y = resample_poly(_sine(sr_in), sr_in, sr_out)
    assert y.dtype == np.float32 and len(y) == sr_out
    ref = _sine(sr_out).astype(np.float64)
    mid = slice(len(y) // 10, -(len(y) // 10))
    peak = float(np.abs(y[mid]).max())
    assert abs(peak - AMP) <= 0.01 * AMP, peak
    err = np.linalg.norm(y[mid] - ref[mid]) / np.linalg.norm(ref[mid])
    assert err <= 1e-3, err


def test_same_rate_is_untouched():
    x = _sine(32000)
    assert resample_poly(x, 32000, 32000) is x


def test_reference_audio_reaches_no_native_library(tmp_path):
    """The port's reference-clip path (read, resample to 32 and 16 kHz)
    loads no ``genie_audio`` library and imports nothing of the JAX
    package (a fresh process, so no other test has loaded either)."""
    from genie_tts_tpu_torch.utils.wavio import write_wav

    wav = tmp_path / "ref48k.wav"
    write_wav(wav, _sine(48000), 48000)
    code = (
        "import sys\n"
        "from genie_tts_tpu_torch.runtime import reference_audio as ra\n"
        "from genie_tts_tpu_torch.utils.wavio import read_audio\n"
        f"audio, sr = read_audio({str(wav)!r})\n"
        "a32 = ra.resample_poly(audio, sr, 32000)\n"
        "a16 = ra.resample_poly(a32, 32000, 16000)\n"
        "assert abs(abs(a32[3200:-3200]).max() - 0.3) < 0.003\n"
        "maps = open('/proc/self/maps').read()\n"
        "assert 'genie_audio' not in maps\n"
        "assert not [m for m in sys.modules if m.split('.')[0] in ('jax', 'genie_tts_tpu')]\n"
        "print('RESAMPLE-OK')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300)
    assert "RESAMPLE-OK" in out.stdout, out.stderr[-2000:]
