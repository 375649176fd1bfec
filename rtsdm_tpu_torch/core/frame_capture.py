"""FrameCapture: write the active graph's marked outputs to files
(counterpart of rtsdm_tpu/core/frame_capture.py; reference Source/Mogwai/
Extensions/Capture/FrameCapture.h:35, the basis of the image tests).

Files are named as the reference names them,
<baseFilename>.<graph>.<pass>.<channel>.<frame>: the exact .npy, and a
.png preview where PIL is installed.
"""
from __future__ import annotations

import os

import numpy as np


def _to_u8(img):
    """An image as 8-bit RGB for the preview (the reference's mapping)."""
    a = np.asarray(img, np.float32)
    if a.ndim == 2:
        a = a[..., None]
    if a.shape[-1] == 1:
        a = np.repeat(a, 3, axis=-1)
    if a.shape[-1] == 2:
        a = np.concatenate([a, np.zeros_like(a[..., :1])], -1)
    return (np.clip(a[..., :3], 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)


class FrameCapture:
    """m.frameCapture: capture() writes the last rendered frame's marked
    outputs under outputDir."""

    def __init__(self):
        self.outputDir = "."
        self.baseFilename = "Mogwai"
        self.format = "npy"
        self.captured: list[str] = []
        self._renderer = None

    def _attach(self, renderer):
        self._renderer = renderer

    def capture(self) -> list[str]:
        """Write every marked output of the last frame as .npy (exact) and
        a .png preview; returns the .npy paths."""
        if self.format in ("exr", "png"):
            raise NotImplementedError(
                f"FrameCapture format {self.format!r}: utils/image_io.py is "
                "not ported yet (ROADMAP queue 1, item 11); use 'npy'")
        r = self._renderer
        if r is None or r._last_outputs is None:
            raise RuntimeError("no rendered frame to capture")
        os.makedirs(self.outputDir, exist_ok=True)
        frame = r.clock.frame
        files = []
        for name, arr in r._last_outputs.items():
            a = arr.detach().cpu().numpy()
            base = os.path.join(
                self.outputDir,
                f"{self.baseFilename}.{r.active_graph.name}.{name}.{frame}")
            np.save(base + ".npy", a)
            _save_preview(base + ".png", a)
            files.append(base + ".npy")
        self.captured.extend(files)
        return files


def _save_preview(path: str, a) -> None:
    """The .png preview, skipped where PIL is missing or cannot hold the
    array's shape (the reference writes none there either)."""
    try:
        from PIL import Image
    except ImportError:
        return
    try:
        img = Image.fromarray(_to_u8(a))
    except (TypeError, ValueError):
        return
    img.save(path)
