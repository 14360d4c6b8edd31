"""Logging payload formatting: grids, videos, tables, scalars.

The port's copy of ``flow_factory_tpu/logger/formatting.py`` (numpy only):
sample media → backend-ready payloads. Image grids with captions, mp4
encoding (with muxed audio when the sample carries a waveform), I2V/I2I
condition-vs-result tables, and console scalar summarization. PIL, imageio
and ffmpeg are optional: without a video codec a video becomes an animated
GIF with a sidecar WAV, and without PIL an image or GIF is not written (a
warning says so).
"""
from __future__ import annotations

import logging
import os
import tempfile
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

logger = logging.getLogger(__name__)


def make_image_grid(
    images: Sequence[np.ndarray],
    captions: Optional[Sequence[str]] = None,
    cols: int = 4,
    pad: int = 2,
) -> np.ndarray:
    """Canonical (C,H,W) images → one (H',W',3) uint8 grid."""
    imgs = [np.transpose(np.asarray(i), (1, 2, 0)) for i in images]
    imgs = [(np.clip(i, 0, 1) * 255).astype(np.uint8) for i in imgs]
    h = max(i.shape[0] for i in imgs)
    w = max(i.shape[1] for i in imgs)
    cols = min(cols, len(imgs))
    rows = -(-len(imgs) // cols)
    grid = np.full((rows * (h + pad) - pad, cols * (w + pad) - pad, 3), 255, np.uint8)
    for idx, img in enumerate(imgs):
        r, c = divmod(idx, cols)
        grid[r * (h + pad): r * (h + pad) + img.shape[0],
             c * (w + pad): c * (w + pad) + img.shape[1]] = img
    return grid


def _video_frames_uint8(video: np.ndarray) -> np.ndarray:
    """Canonical (T,C,H,W) float [0,1] → (T,H,W,3) uint8."""
    return (np.clip(np.transpose(np.asarray(video), (0, 2, 3, 1)), 0, 1) * 255).astype(np.uint8)


def write_wav(path: str, audio: np.ndarray, sample_rate: int) -> str:
    """(C, N) or (N,) float waveform → 16-bit PCM WAV (stdlib only)."""
    import wave

    a = np.asarray(audio, np.float32)
    if a.ndim == 1:
        a = a[None]
    pcm = (np.clip(a.T, -1.0, 1.0) * 32767.0).astype("<i2")
    with wave.open(path, "wb") as w:
        w.setnchannels(pcm.shape[1])
        w.setsampwidth(2)
        w.setframerate(int(sample_rate))
        w.writeframes(np.ascontiguousarray(pcm).tobytes())
    return path


def save_video_mp4(
    video: np.ndarray,
    path: str,
    fps: int = 8,
    audio: Optional[np.ndarray] = None,
    audio_sample_rate: int = 24000,
) -> Optional[str]:
    """Canonical (T,C,H,W) video → mp4; muxes audio when ffmpeg supports it.

    Returns the written path or None when no video codec is available
    (imageio-ffmpeg/pyav are optional at runtime — see
    :func:`save_video_media` for the no-codec fallback).
    """
    frames = _video_frames_uint8(video)
    try:
        import imageio.v3 as iio

        iio.imwrite(path, frames, fps=fps, extension=".mp4")
    except Exception as e:
        logger.warning("mp4 encode unavailable (%s); skipping video log", e)
        return None
    if audio is not None:
        try:
            import shutil
            import subprocess

            ffmpeg = shutil.which("ffmpeg")
            if ffmpeg is None:
                raise RuntimeError("no ffmpeg binary")
            wav = path + ".wav"
            write_wav(wav, audio, audio_sample_rate)
            muxed = path + ".muxed.mp4"
            subprocess.run(
                [ffmpeg, "-y", "-loglevel", "error", "-i", path, "-i", wav,
                 "-c:v", "copy", "-c:a", "aac", "-shortest", muxed],
                check=True,
            )
            os.replace(muxed, path)
            os.remove(wav)
        except Exception as e:
            # keep the video; ship the waveform as a sidecar WAV instead
            logger.warning("audio mux skipped (%s); writing sidecar wav", e)
            try:
                write_wav(os.path.splitext(path)[0] + ".wav", audio, audio_sample_rate)
            except Exception:
                pass
    return path


def save_video_gif(video: np.ndarray, path: str, fps: int = 8) -> Optional[str]:
    """PIL-only animated-GIF fallback (always available; no audio track)."""
    try:
        from PIL import Image

        frames = [Image.fromarray(f) for f in _video_frames_uint8(video)]
        frames[0].save(
            path, save_all=True, append_images=frames[1:],
            duration=max(1, int(round(1000.0 / fps))), loop=0,
        )
        return path
    except Exception as e:
        logger.warning("gif encode failed (%s); video not logged", e)
        return None


def save_video_media(
    video: np.ndarray,
    base_path: str,
    fps: int = 8,
    audio: Optional[np.ndarray] = None,
    audio_sample_rate: Optional[int] = None,
) -> Optional[str]:
    """Best-available encode: mp4 (+aac mux) when a codec exists, else GIF
    with a sidecar 16-bit WAV for the audio track. Returns the media path."""
    sr = int(audio_sample_rate or 24000)
    out = save_video_mp4(video, base_path + ".mp4", fps=fps, audio=audio,
                         audio_sample_rate=sr)
    if out is not None:
        return out
    out = save_video_gif(video, base_path + ".gif", fps=fps)
    if out is not None and audio is not None:
        try:
            write_wav(base_path + ".wav", audio, sr)
        except Exception as e:
            logger.warning("sidecar wav failed: %s", e)
    return out


def samples_to_media_payload(samples: Sequence[Any], max_items: int = 30) -> Dict[str, Any]:
    """Sample list → {'images': [...], 'videos': [...], 'captions': [...]}.

    Caption carries prompt + reward (reference grid captioning).
    """
    payload: Dict[str, Any] = {"images": [], "videos": [], "audios": [], "captions": []}
    for s in list(samples)[:max_items]:
        cap = (s.prompt or "")[:120]
        r = s.extra_kwargs.get("reward")
        if r is not None:
            cap = f"{cap} | r={r:.4f}"
        payload["captions"].append(cap)
        if getattr(s, "image", None) is not None:
            payload["images"].append(s.image)
        if getattr(s, "video", None) is not None:
            payload["videos"].append((s.video, getattr(s, "audio", None),
                                      getattr(s, "audio_sample_rate", None)))
    return payload


def condition_result_table(samples: Sequence[Any], max_items: int = 16) -> List[Dict[str, Any]]:
    """I2I/I2V rows: condition media + result + prompt + reward
    (reference formatting.py:592-...)."""
    rows = []
    for s in list(samples)[:max_items]:
        rows.append({
            "prompt": s.prompt,
            "reward": s.extra_kwargs.get("reward"),
            "conditions": getattr(s, "images", None) or getattr(s, "condition_video", None),
            "result": s.image if getattr(s, "image", None) is not None else s.video,
        })
    return rows


class LogFormatter:
    """Console scalar summarization (reference ``LogFormatter.to_scalar``)."""

    @staticmethod
    def to_scalar(data: Dict[str, Any]) -> Dict[str, float]:
        out = {}
        for k, v in data.items():
            try:
                arr = np.asarray(v, dtype=np.float64)
            except (TypeError, ValueError):
                continue
            if arr.ndim == 0:
                out[k] = float(arr)
            elif arr.size:
                out[f"{k}_mean"] = float(arr.mean())
        return out
