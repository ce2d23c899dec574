"""The port's host audio ops against ``vaura_tpu.ops.audio`` on seeded
waveforms: every ``normalize_audio`` strategy, integrated loudness,
polyphase resampling, the WAV writer and reader, the stream header and its
sample encoding, and the log-mel spectrogram. Both are numpy and scipy, so
the results must be equal."""

import io

import numpy as np
import pytest

from vaura_tpu.ops import audio as J
from vaura_tpu_torch.ops import audio as T


def _wav(seed=0, shape=(1, 44100), scale=0.3):
    rng = np.random.default_rng(seed)
    t = np.arange(shape[-1]) / 44100.0
    tone = np.sin(2 * np.pi * 330 * t) * scale
    return (tone + 0.1 * scale * rng.standard_normal(shape)).astype(np.float32)


@pytest.mark.parametrize("strategy", ["peak", "clip", "rms", "loudness", "none"])
@pytest.mark.parametrize("scale", [0.01, 0.3, 3.0])
def test_normalize_audio_matches_jax(strategy, scale):
    wav = _wav(1, (2, 22050), scale)
    kw = dict(strategy=strategy, sample_rate=44100)
    np.testing.assert_array_equal(T.normalize_audio(wav, **kw),
                                  J.normalize_audio(wav, **kw))
    kw["normalize"] = False
    np.testing.assert_array_equal(T.normalize_audio(wav, **kw),
                                  J.normalize_audio(wav, **kw))
    with pytest.raises(ValueError):
        T.normalize_audio(wav, strategy="nope")


@pytest.mark.parametrize("n", [1000, 17640, 44100 * 2])
def test_integrated_loudness_matches_jax(n):
    for wav in (_wav(2, (1, n)), _wav(3, (2, n), 1e-4), np.zeros((1, n))):
        assert T.integrated_loudness(wav, 44100) == J.integrated_loudness(wav, 44100)


@pytest.mark.parametrize("orig,target", [(44100, 16000), (16000, 44100),
                                         (48000, 44100), (44100, 44100)])
def test_resample_poly_matches_jax(orig, target):
    wav = _wav(4, (2, 4410))
    np.testing.assert_array_equal(T.resample_poly(wav, orig, target),
                                  J.resample_poly(wav, orig, target))


@pytest.mark.parametrize("channels", [1, 2])
def test_wav_round_trip_matches_jax(tmp_path, channels):
    wav = _wav(5, (channels, 1234), 1.2)  # clipped beyond [-1, 1]
    T.write_wav(tmp_path / "t.wav", wav, 44100)
    J.write_wav(tmp_path / "j.wav", wav, 44100)
    assert (tmp_path / "t.wav").read_bytes() == (tmp_path / "j.wav").read_bytes()
    got, sr = T.read_wav(tmp_path / "t.wav")
    want, _ = J.read_wav(tmp_path / "j.wav")
    assert sr == 44100 and got.shape == (channels, 1234)
    np.testing.assert_array_equal(got, want)
    # truncation to int16 and the 32767 / 32768 scales: under 2 steps
    assert np.abs(got - np.clip(wav, -1, 1)).max() <= 2.0 / 32767
    buf = io.BytesIO()
    T.write_wav(buf, wav[0], 16000)  # a file-like destination, a [T] waveform
    assert buf.getvalue()[:4] == b"RIFF"


def test_stream_header_and_pcm16_match_jax():
    wav = _wav(6, (2, 100))
    assert T.wav_stream_header(44100, 2) == J.wav_stream_header(44100, 2)
    assert T.pcm16(wav) == J.pcm16(wav)
    assert T.pcm16(wav[0]) == J.pcm16(wav[0])


def test_log_mel_matches_jax():
    wav = _wav(7, (1, 8000))
    np.testing.assert_array_equal(T.log_mel(wav, 16000), J.log_mel(wav, 16000))
