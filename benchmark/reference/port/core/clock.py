"""Deterministic clock (counterpart of rtsdm_tpu/core/clock.py; reference
Utils/Timing/Clock.h:41). Image tests pause it and step exact frames."""
from __future__ import annotations


class Clock:
    def __init__(self, framerate: int = 60):
        self.framerate = framerate
        self._frame = 0
        self._paused = False
        self._time = 0.0

    # the m.clock script API (reference MogwaiScripting.cpp:127-179)
    def pause(self):
        self._paused = True

    def play(self):
        self._paused = False

    @property
    def paused(self) -> bool:
        return self._paused

    @property
    def frame(self) -> int:
        return self._frame

    @frame.setter
    def frame(self, f: int):
        self._frame = int(f)
        self._time = self._frame / self.framerate

    @property
    def time(self) -> float:
        return self._time

    @time.setter
    def time(self, t: float):
        self._time = float(t)
        self._frame = int(round(t * self.framerate))

    def tick(self):
        """Advance one frame unless paused (SampleApp.cpp:484)."""
        if not self._paused:
            self.step()

    def step(self, frames: int = 1):
        self._frame += frames
        self._time = self._frame / self.framerate
