"""Python binding for the native libav media module (ctypes).

Counterpart of ``vaura_tpu/data/media.py``: the same C++ module
(``native/media/vaura_media.cpp``), built on demand with ``make -C
native/media`` (g++ and libav headers) under a file lock, so that processes
that reach a first use together build it once. Where the toolchain or libav is
absent every function raises ``MediaError`` and ``available()`` is false,
as on the JAX side.

API:
  * ``probe(path)`` -> dict (duration, fps, geometry, audio sr/channels)
  * ``read_video(path, start, duration, fps, size, sr)`` ->
    (frames [N,H,W,3] uint8, audio [1,S] float32, info)
  * ``write_video(path, frames, fps, audio, sr, crf)`` — h264+aac mux
  * ``reencode(in, out, fps=25, min_side=256, crf=10, sr=44100)`` — the
    dataset re-encoder contract (reference ``reencode_videos.py:19-26``)
"""

from __future__ import annotations

import ctypes
import fcntl
import subprocess
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

_NATIVE_DIR = Path(__file__).resolve().parents[2] / "native" / "media"
_LIB_PATH = _NATIVE_DIR / "libvaura_media.so"
_lib = None


class MediaError(RuntimeError):
    pass


class _VmProbe(ctypes.Structure):
    _fields_ = [
        ("duration", ctypes.c_double),
        ("video_fps", ctypes.c_double),
        ("width", ctypes.c_int),
        ("height", ctypes.c_int),
        ("audio_sample_rate", ctypes.c_int),
        ("audio_channels", ctypes.c_int),
        ("n_video_frames", ctypes.c_int64),
        ("has_video", ctypes.c_int),
        ("has_audio", ctypes.c_int),
    ]


class _VmDecoded(ctypes.Structure):
    _fields_ = [
        ("frames", ctypes.POINTER(ctypes.c_uint8)),
        ("n_frames", ctypes.c_int64),
        ("width", ctypes.c_int),
        ("height", ctypes.c_int),
        ("fps", ctypes.c_double),
        ("audio", ctypes.POINTER(ctypes.c_float)),
        ("n_samples", ctypes.c_int64),
        ("sample_rate", ctypes.c_int),
        ("first_video_pts", ctypes.c_double),
    ]


def _build() -> None:
    try:
        subprocess.run(
            ["make", "-C", str(_NATIVE_DIR)],
            check=True,
            capture_output=True,
            text=True,
        )
    except subprocess.CalledProcessError as e:
        raise MediaError(
            f"building native media module failed:\n{e.stderr}"
        ) from e


def _load():
    global _lib
    if _lib is not None:
        return _lib
    # several processes (the workers of a test run) may reach a first use
    # at once: without the lock, one would load the library while another's
    # make is still writing it
    with open(_NATIVE_DIR / ".build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not _LIB_PATH.exists():
            _build()
        lib = ctypes.CDLL(str(_LIB_PATH))
    lib.vm_probe.argtypes = [ctypes.c_char_p, ctypes.POINTER(_VmProbe)]
    lib.vm_probe.restype = ctypes.c_int
    lib.vm_decode.argtypes = [
        ctypes.c_char_p,
        ctypes.c_double,
        ctypes.c_double,
        ctypes.c_double,
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_int,
        ctypes.POINTER(_VmDecoded),
    ]
    lib.vm_decode.restype = ctypes.c_int
    lib.vm_free_decoded.argtypes = [ctypes.POINTER(_VmDecoded)]
    lib.vm_write_video.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int64,
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_double,
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_float),
        ctypes.c_int64,
        ctypes.c_int,
    ]
    lib.vm_write_video.restype = ctypes.c_int
    lib.vm_last_error.restype = ctypes.c_char_p
    _lib = lib
    return lib


def _check(lib, rc: int, what: str) -> None:
    if rc != 0:
        raise MediaError(f"{what}: {lib.vm_last_error().decode()}")


def available() -> bool:
    try:
        _load()
        return True
    except Exception:
        return False


def probe(path: str | Path) -> dict:
    lib = _load()
    out = _VmProbe()
    _check(lib, lib.vm_probe(str(path).encode(), ctypes.byref(out)), f"probe {path}")
    return {
        "duration": out.duration,
        "video_fps": out.video_fps,
        "width": out.width,
        "height": out.height,
        "audio_sample_rate": out.audio_sample_rate,
        "audio_channels": out.audio_channels,
        "n_video_frames": out.n_video_frames,
        "has_video": bool(out.has_video),
        "has_audio": bool(out.has_audio),
    }


def read_video(
    path: str | Path,
    start: float = 0.0,
    duration: float = -1.0,
    fps: float = -1.0,
    size: Optional[Tuple[int, int]] = None,
    min_side: int = -1,
    sample_rate: int = -1,
    want_video: bool = True,
    want_audio: bool = True,
) -> Tuple[Optional[np.ndarray], Optional[np.ndarray], dict]:
    """Decode ``(frames [N,H,W,3] uint8, audio [1,S] float32 mono, info)``.

    Replaces reference ``read_video_to_frames_and_audio_streams``
    (``utils/data_utils.py:23-...``).
    """
    lib = _load()
    out = _VmDecoded()
    tw, th = (size if size else (-1, -1))
    rc = lib.vm_decode(
        str(path).encode(),
        float(start),
        float(duration),
        float(fps),
        int(tw),
        int(th),
        int(min_side),
        int(sample_rate),
        int(want_video),
        int(want_audio),
        ctypes.byref(out),
    )
    _check(lib, rc, f"decode {path}")
    try:
        frames = None
        audio = None
        if want_video and out.n_frames > 0:
            n = out.n_frames * out.height * out.width * 3
            frames = np.ctypeslib.as_array(out.frames, shape=(n,)).copy()
            frames = frames.reshape(out.n_frames, out.height, out.width, 3)
        if want_audio and out.n_samples > 0:
            audio = np.ctypeslib.as_array(out.audio, shape=(out.n_samples,)).copy()
            audio = audio[None, :]
        info = {
            "video_fps": out.fps,
            "audio_fps": out.sample_rate,
            "first_video_pts": out.first_video_pts,
        }
        return frames, audio, info
    finally:
        lib.vm_free_decoded(ctypes.byref(out))


def write_video(
    path: str | Path,
    frames: np.ndarray,  # [N, H, W, 3] uint8 or float in [0,1]
    fps: float,
    audio: Optional[np.ndarray] = None,  # [S] or [1, S] float
    audio_sample_rate: int = 44100,
    crf: int = 10,
) -> None:
    """h264(crf)+aac mux (reference ``write_video``/reencode contract)."""
    lib = _load()
    frames = np.asarray(frames)
    if frames.dtype != np.uint8:
        frames = (np.clip(frames, 0.0, 1.0) * 255).astype(np.uint8)
    frames = np.ascontiguousarray(frames)
    n, h, w, c = frames.shape
    assert c == 3
    audio_ptr = None
    n_samples = 0
    if audio is not None:
        audio = np.ascontiguousarray(np.asarray(audio, np.float32).reshape(-1))
        n_samples = audio.shape[0]
        audio_ptr = audio.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
    rc = lib.vm_write_video(
        str(path).encode(),
        frames.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        n,
        w,
        h,
        float(fps),
        int(crf),
        audio_ptr,
        n_samples,
        int(audio_sample_rate),
    )
    _check(lib, rc, f"write {path}")


def reencode(
    src: str | Path,
    dst: str | Path,
    fps: float = 25.0,
    min_side: int = 256,
    crf: int = 10,
    sample_rate: int = 44100,
) -> None:
    """Dataset re-encoder (reference ``scripts/reencode_videos.py:19-26``):
    25 fps, min-side 256, h264 crf10 yuv420p, 44.1 kHz mono aac."""
    frames, audio, info = read_video(
        src, fps=fps, min_side=min_side, sample_rate=sample_rate
    )
    if frames is None:
        raise MediaError(f"no video stream in {src}")
    write_video(
        dst,
        frames,
        fps=fps,
        audio=audio[0] if audio is not None else None,
        audio_sample_rate=sample_rate,
        crf=crf,
    )
