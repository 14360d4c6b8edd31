"""Experiment logging backends.

The port's copy of ``flow_factory_tpu/logger/logger.py``: console and the
append-only ``metrics.jsonl`` record (media files under ``media/``, each
batch of them named by a ``media_tag``/``media_paths`` row of the record)
always, plus the named backend — tensorboard (``torch.utils.tensorboard``),
wandb or swanlab. A backend that is unknown or cannot start is skipped with
a warning. Media payloads are canonical numpy arrays from the sample layer.
"""
from __future__ import annotations

import json
import logging
import os
import time
from abc import ABC, abstractmethod
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

logger = logging.getLogger(__name__)


class BaseLogger(ABC):
    def __init__(self, log_args, run_name: str):
        self.log_args = log_args
        self.run_name = run_name

    @abstractmethod
    def log_data(self, data: Dict[str, Any], step: int) -> None: ...

    def log_images(self, tag: str, images: Sequence[np.ndarray], captions=None, step: int = 0):
        pass

    def log_videos(self, tag: str, videos, captions=None, step: int = 0, fps: int = 8):
        pass

    def finish(self) -> None:
        pass


def _encode_videos_to_files(
    videos, out_dir: str, tag: str, step: int, fps: int, limit: int = 8
) -> List[str]:
    """Shared backend helper: payload items are ``(video, audio, sr)`` tuples
    (``formatting.samples_to_media_payload``) or bare arrays. Returns the
    written media paths (mp4 when a codec exists, else gif + sidecar wav)."""
    from .formatting import save_video_media

    os.makedirs(out_dir, exist_ok=True)
    paths: List[str] = []
    for i, item in enumerate(list(videos)[:limit]):
        video, audio, sr = item if isinstance(item, tuple) else (item, None, None)
        base = os.path.join(out_dir, f"{tag.replace('/', '_')}_s{step}_{i}")
        p = save_video_media(video, base, fps=fps, audio=audio, audio_sample_rate=sr)
        if p:
            paths.append(p)
    return paths


class ConsoleLogger(BaseLogger):
    def log_data(self, data: Dict[str, Any], step: int) -> None:
        scalars = {k: round(float(v), 5) for k, v in data.items() if np.isscalar(v) or getattr(v, "ndim", 1) == 0}
        logger.info("[step %d] %s", step, json.dumps(scalars, sort_keys=True))


class JSONLLogger(BaseLogger):
    """Append-only metrics file — the machine-readable run record."""

    def __init__(self, log_args, run_name: str):
        super().__init__(log_args, run_name)
        out_dir = os.path.join(getattr(log_args, "save_dir", "saves"), run_name)
        os.makedirs(out_dir, exist_ok=True)
        self.path = os.path.join(out_dir, "metrics.jsonl")

    def log_data(self, data: Dict[str, Any], step: int) -> None:
        row = {"step": step, "time": time.time()}
        for k, v in data.items():
            try:
                row[k] = float(v)
            except (TypeError, ValueError):
                continue
        with open(self.path, "a") as f:
            f.write(json.dumps(row) + "\n")

    def log_images(self, tag: str, images, captions=None, step: int = 0):
        """PNG grid next to the metrics file — every run ships visible media
        even with no wandb/TB backend attached."""
        try:
            from PIL import Image

            from .formatting import make_image_grid

            media = os.path.join(os.path.dirname(self.path), "media")
            os.makedirs(media, exist_ok=True)
            grid = make_image_grid(images, captions)
            out = os.path.join(media, f"{tag.replace('/', '_')}_s{step}.png")
            Image.fromarray(grid).save(out)
            self._append_media_row(tag, step, [out])
        except Exception as e:
            logger.warning("jsonl image dump failed: %s", e)

    def log_videos(self, tag: str, videos, captions=None, step: int = 0, fps: int = 8):
        media = os.path.join(os.path.dirname(self.path), "media")
        paths = _encode_videos_to_files(videos, media, tag, step, fps)
        if paths:
            self._append_media_row(tag, step, paths)

    def _append_media_row(self, tag: str, step: int, paths: List[str]) -> None:
        with open(self.path, "a") as f:
            f.write(json.dumps({"step": step, "time": time.time(),
                                "media_tag": tag, "media_paths": paths}) + "\n")


class TensorboardLogger(BaseLogger):
    def __init__(self, log_args, run_name: str):
        super().__init__(log_args, run_name)
        from torch.utils.tensorboard import SummaryWriter

        out_dir = os.path.join(getattr(log_args, "save_dir", "saves"), run_name, "tb")
        self.writer = SummaryWriter(out_dir)

    def log_data(self, data: Dict[str, Any], step: int) -> None:
        for k, v in data.items():
            try:
                self.writer.add_scalar(k, float(v), step)
            except (TypeError, ValueError):
                continue

    def log_images(self, tag: str, images, captions=None, step: int = 0):
        for i, img in enumerate(images[:16]):
            self.writer.add_image(f"{tag}/{i}", np.asarray(img), step)

    def log_videos(self, tag: str, videos, captions=None, step: int = 0, fps: int = 8):
        """Embedded TB video when moviepy is available (reference
        ``logger/tensorboard.py:96`` add_video); otherwise mp4/gif files in
        the TB dir + first frames as images so the run is never blind."""
        import torch

        try:
            import moviepy  # noqa: F401  (torch's add_video silently no-ops without it)

            have_moviepy = True
        except ImportError:
            have_moviepy = False
        embedded = False
        for i, item in enumerate(list(videos)[:8]):
            video = item[0] if isinstance(item, tuple) else item
            frames = np.clip(np.transpose(np.asarray(video), (0, 2, 3, 1)), 0, 1)
            if have_moviepy:
                vid = torch.from_numpy(
                    (frames * 255).astype(np.uint8).transpose(0, 3, 1, 2)[None]
                )  # (1, T, C, H, W)
                try:
                    self.writer.add_video(f"{tag}/{i}", vid, step, fps=fps)
                    embedded = True
                    continue
                except Exception:
                    pass
            self.writer.add_image(
                f"{tag}/{i}/frame0",
                (frames[0].transpose(2, 0, 1) * 255).astype(np.uint8), step)
        if not embedded:
            _encode_videos_to_files(
                videos, os.path.join(self.writer.log_dir, "media"), tag, step, fps)

    def finish(self) -> None:
        self.writer.close()


class WandbLogger(BaseLogger):
    def __init__(self, log_args, run_name: str):
        super().__init__(log_args, run_name)
        import wandb

        self.wandb = wandb
        self.run = wandb.init(
            project=getattr(log_args, "project", "flow-factory-tpu"),
            name=run_name,
            config=getattr(log_args, "config_snapshot", None),
        )

    def log_data(self, data: Dict[str, Any], step: int) -> None:
        self.run.log(dict(data), step=step)

    def log_images(self, tag: str, images, captions=None, step: int = 0):
        captions = captions or [None] * len(images)
        payload = [
            self.wandb.Image(np.transpose(np.asarray(i), (1, 2, 0)), caption=c)
            for i, c in zip(images[:30], captions)
        ]
        self.run.log({tag: payload}, step=step)

    def log_videos(self, tag: str, videos, captions=None, step: int = 0, fps: int = 8):
        """wandb.Video of the muxed mp4 (reference ``logger/wandb.py:41``)."""
        import tempfile

        captions = captions or [None] * len(videos)
        tmp = tempfile.mkdtemp(prefix="ff_wandb_media_")
        payload = []
        for path, cap in zip(_encode_videos_to_files(videos, tmp, tag, step, fps),
                             captions):
            fmt = os.path.splitext(path)[1].lstrip(".")
            payload.append(self.wandb.Video(path, caption=cap, format=fmt))
        if payload:
            self.run.log({tag: payload}, step=step)

    def finish(self) -> None:
        self.run.finish()


class MultiLogger(BaseLogger):
    def __init__(self, backends: List[BaseLogger]):
        self.backends = backends

    def log_data(self, data, step):
        for b in self.backends:
            b.log_data(data, step)

    def log_images(self, tag, images, captions=None, step=0):
        for b in self.backends:
            b.log_images(tag, images, captions=captions, step=step)

    def log_videos(self, tag, videos, captions=None, step=0, fps=8):
        for b in self.backends:
            b.log_videos(tag, videos, captions=captions, step=step, fps=fps)

    def finish(self):
        for b in self.backends:
            b.finish()


class SwanlabLogger(BaseLogger):
    def __init__(self, log_args, run_name: str):
        super().__init__(log_args, run_name)
        import swanlab

        self.swanlab = swanlab
        self.run = swanlab.init(
            project=getattr(log_args, "project", "flow-factory-tpu"), experiment_name=run_name
        )

    def log_data(self, data: Dict[str, Any], step: int) -> None:
        payload = {}
        for k, v in data.items():
            try:
                payload[k] = float(v)
            except (TypeError, ValueError):
                continue
        self.swanlab.log(payload, step=step)

    def log_images(self, tag, images, captions=None, step=0):
        captions = captions or [None] * len(images)
        payload = [
            self.swanlab.Image(np.transpose(np.asarray(i), (1, 2, 0)), caption=c)
            for i, c in zip(images[:30], captions)
        ]
        self.swanlab.log({tag: payload}, step=step)

    def log_videos(self, tag: str, videos, captions=None, step: int = 0, fps: int = 8):
        import tempfile

        video_cls = getattr(self.swanlab, "Video", None)
        tmp = tempfile.mkdtemp(prefix="ff_swanlab_media_")
        paths = _encode_videos_to_files(videos, tmp, tag, step, fps)
        if video_cls is None:
            # older swanlab: fall back to first-frame images
            imgs = [np.asarray(v[0] if isinstance(v, tuple) else v)[0]
                    for v in list(videos)[:8]]
            self.log_images(tag, imgs, captions=captions, step=step)
            return
        captions = captions or [None] * len(paths)
        payload = [video_cls(p, caption=c) for p, c in zip(paths, captions)]
        if payload:
            self.swanlab.log({tag: payload}, step=step)

    def finish(self) -> None:
        self.swanlab.finish()


_LOGGER_REGISTRY = {
    "console": ConsoleLogger,
    "jsonl": JSONLLogger,
    "tensorboard": TensorboardLogger,
    "wandb": WandbLogger,
    "swanlab": SwanlabLogger,
}


def load_logger(log_args, run_name: str, is_main_process: bool = True) -> Optional[BaseLogger]:
    """The main process's loggers (None on the others): ``report_to`` (a name
    or a list) when set, else console + jsonl + ``logging_backend`` unless it
    is ``none``."""
    if not is_main_process:
        return None
    wanted = getattr(log_args, "report_to", None)
    if wanted is None:
        backend = getattr(log_args, "logging_backend", "none")
        wanted = ["console", "jsonl"] + ([] if backend in (None, "none") else [backend])
    if isinstance(wanted, str):
        wanted = [wanted]
    backends: List[BaseLogger] = []
    for name in wanted:
        cls = _LOGGER_REGISTRY.get(name)
        if cls is None:
            logger.warning("Unknown logger backend %r; skipping", name)
            continue
        try:
            backends.append(cls(log_args, run_name))
        except Exception as e:
            logger.warning("Logger backend %r unavailable (%s); skipping", name, e)
    if not backends:
        backends = [ConsoleLogger(log_args, run_name)]
    return MultiLogger(backends)
