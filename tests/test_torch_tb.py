"""The port's TensorBoard logger (``vaura_tpu_torch/utils/tb.py``, event
files written with the standard library and numpy) against the JAX
package's (``vaura_tpu/utils/tb.py``, ``tensorboardX`` and PIL): the same
calls go to both, and both files are read back with ``tensorboard``'s
``EventAccumulator``, which checks every record's CRC.

Held equal: the tags and steps, every scalar, the custom-scalars layout
(byte for byte), every histogram field (min, max, num, sum, sum of squares,
bucket limits and counts) and the decoded WAV samples. The GIFs of
``video`` differ in encoder and palette: frame count and size must be
equal, and each pixel of the port's decoded GIF within the fixed palette's
error of the JAX logger's decoded GIF (0 for gray frames, where both
palettes are exact; 26 for colour: half the widest step of the port's
palette, 51, rounded up). ``test_gif_encoder_round_trip`` holds the port's
GIFs to the frames themselves."""

import io
import wave

import numpy as np
import pytest
from PIL import Image
from tensorboard.backend.event_processing.event_accumulator import (
    EventAccumulator,
)

from vaura_tpu.utils.tb import TBLogger as JLogger
from vaura_tpu_torch.utils import tb as T
from vaura_tpu_torch.utils.viz import attn_rows_to_video, scale_to_01
from vaura_tpu.utils import viz as JV

COLOR_TOL = 26


def _log(logger, rng_seed=0):
    """The calls of the Trainer: layout, scalars, per-codebook scalars,
    audio, a gray attention video, a colour video, histograms."""
    rng = np.random.default_rng(rng_seed)
    logger.add_custom_scalar_layout(3)
    for step in (1, 2, 3):
        logger.scalar("train_loss_step", float(rng.standard_normal()), step)
        logger.scalar("lr", 1e-3 * step, step)
    logger.scalars_per_codebook("val_loss_per_codebook",
                                rng.random(3).astype(np.float32), 3)
    logger.audio("generated_audio/clip", np.clip(
        0.4 * rng.standard_normal(1234), -1, 1), 3, 44100)
    logger.video("s_attention_weights/clip",
                 attn_rows_to_video(rng.random((9, 14))), 3, fps=10)
    logger.video("conditioned_frames/clip",
                 scale_to_01(rng.standard_normal((5, 12, 10, 3))), 3, fps=25)
    logger.video("as_clip", rng.random((1, 4, 3, 6, 8)), 4, fps=25)
    logger.histogram("sampled_indices/clip",
                     rng.integers(0, 1024, (9, 40)), 3)
    logger.histogram("signed", rng.standard_normal(500) * 3.0, 4)
    logger.histogram("one_value", np.full(7, 5.0), 5)
    logger.flush()
    logger.close()


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    root = tmp_path_factory.mktemp("tb")
    _log(JLogger(str(root / "jax")))
    logger = T.TBLogger(str(root / "port"))
    _log(logger)
    out = []
    for name in ("jax", "port"):
        acc = EventAccumulator(str(root / name), size_guidance={
            "scalars": 0, "images": 0, "audio": 0, "histograms": 0,
            "tensors": 0})
        acc.Reload()
        acc.log_dir = root / name
        out.append(acc)
    return out


def test_same_tags(pair):
    j, t = pair
    jt, tt = j.Tags(), t.Tags()
    for kind in ("scalars", "images", "audio", "histograms", "tensors"):
        assert sorted(tt[kind]) == sorted(jt[kind]), kind
    assert len(tt["scalars"]) == 5 and len(tt["images"]) == 3


def test_scalars_equal(pair):
    j, t = pair
    for tag in j.Tags()["scalars"]:
        got = [(e.step, e.value) for e in t.Scalars(tag)]
        want = [(e.step, e.value) for e in j.Scalars(tag)]
        assert got == want, tag


def test_custom_scalar_layout_bytes_equal(pair):
    j, t = pair
    tag = "custom_scalars__config__"
    (jt,), (tt,) = j.Tensors(tag), t.Tensors(tag)
    assert tt.step == jt.step
    assert tt.tensor_proto.SerializeToString() == \
        jt.tensor_proto.SerializeToString()
    assert t.SummaryMetadata(tag).plugin_data.plugin_name == "custom_scalars"


def test_histograms_equal(pair):
    j, t = pair
    for tag in j.Tags()["histograms"]:
        (je,), (te,) = j.Histograms(tag), t.Histograms(tag)
        assert te.step == je.step
        jh, th = je.histogram_value, te.histogram_value
        for f in ("min", "max", "num", "sum", "sum_squares"):
            assert getattr(th, f) == getattr(jh, f), (tag, f)
        assert list(th.bucket_limit) == list(jh.bucket_limit), tag
        assert list(th.bucket) == list(jh.bucket), tag


def test_audio_samples_equal(pair):
    j, t = pair
    tag = "generated_audio/clip"
    (je,), (te,) = j.Audio(tag), t.Audio(tag)
    assert (te.step, te.sample_rate, te.length_frames, te.content_type) == (
        je.step, je.sample_rate, je.length_frames, je.content_type)
    got, sr = _wav(te.encoded_audio_string)
    want, _ = _wav(je.encoded_audio_string)
    assert sr == 44100 and got.shape == (1234,)
    np.testing.assert_array_equal(got, want)


def _wav(data: bytes):
    with wave.open(io.BytesIO(data), "rb") as f:
        assert f.getnchannels() == 1 and f.getsampwidth() == 2
        return (np.frombuffer(f.readframes(f.getnframes()), "<i2"),
                f.getframerate())


def _frames(gif: bytes) -> np.ndarray:
    im = Image.open(io.BytesIO(gif))
    out = []
    for i in range(im.n_frames):
        im.seek(i)
        out.append(np.asarray(im.convert("RGB")))
    return np.stack(out).astype(int)


@pytest.mark.parametrize("tag,tol", [("s_attention_weights/clip", 0),
                                     ("conditioned_frames/clip", COLOR_TOL),
                                     ("as_clip", COLOR_TOL)])
def test_gif_frames_within_the_palette_error(pair, tag, tol):
    j, t = pair
    (je,), (te,) = j.Images(tag), t.Images(tag)
    assert (te.step, te.width, te.height) == (je.step, je.width, je.height)
    got, want = _frames(te.encoded_image_string), _frames(je.encoded_image_string)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol


def test_gif_encoder_round_trip():
    """Exact on gray frames of every value and on a frame long enough to
    fill LZW's table several times; colour within half a palette step."""
    rng = np.random.default_rng(1)
    gray = np.repeat(rng.integers(0, 256, (2, 180, 190, 1), np.uint8), 3, -1)
    np.testing.assert_array_equal(_frames(T.encode_gif(gray, 40)), gray)
    color = rng.integers(0, 256, (3, 17, 23, 3), np.uint8)
    got = _frames(T.encode_gif(color, 100))
    assert np.abs(got - color).max() <= COLOR_TOL


def test_viz_matches_jax():
    rng = np.random.default_rng(2)
    w = rng.random((6, 11)).astype(np.float32)
    np.testing.assert_array_equal(attn_rows_to_video(w),
                                  JV.attn_rows_to_video(w))
    np.testing.assert_array_equal(attn_rows_to_video(w, 3, 5),
                                  JV.attn_rows_to_video(w, 3, 5))
    x = rng.standard_normal((2, 3, 4))
    np.testing.assert_array_equal(scale_to_01(x), JV.scale_to_01(x))


def test_crc32c_and_framing():
    """The CRC-32C check value, and records a plain TFRecord reader takes."""
    assert T.crc32c(b"123456789") == 0xE3069283
    rec = T.tfrecord(b"abc")
    assert len(rec) == 8 + 4 + 3 + 4
    from tensorboard.compat.tensorflow_stub.pywrap_tensorflow import (
        masked_crc32c,
    )
    assert T.masked_crc32c(b"abc") == masked_crc32c(b"abc")


def test_read_events_agrees_with_event_accumulator(pair, tmp_path_factory):
    """``tb.read_events`` (what the card's machine reads without
    ``tensorboard``) sees the tags, kinds, steps and scalar values that
    ``EventAccumulator`` sees, in the port's file and in the JAX one."""
    import glob

    for acc, name in zip(pair, ("jax", "port")):
        (path,) = glob.glob(str(acc.log_dir / "events.out.tfevents.*"))
        ev = T.read_events(path)
        kinds = {"scalar": "scalars", "image": "images", "audio": "audio",
                 "histogram": "histograms", "tensor": "tensors"}
        for kind, key in kinds.items():
            assert sorted({e["tag"] for e in ev if e["kind"] == kind}) == \
                sorted(acc.Tags()[key]), (name, kind)
        for tag in acc.Tags()["scalars"]:
            assert [(e["step"], e["value"]) for e in ev if e["tag"] == tag] \
                == [(s.step, s.value) for s in acc.Scalars(tag)], (name, tag)
    bad = tmp_path_factory.mktemp("bad") / "events.out.tfevents.x"
    data = bytearray(open(path, "rb").read())
    data[30] ^= 1
    bad.write_bytes(bytes(data))
    with pytest.raises(ValueError, match="CRC"):
        T.read_events(str(bad))
