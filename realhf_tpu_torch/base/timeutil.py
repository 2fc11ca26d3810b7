"""Frequency control: triggers every N steps or T seconds, and the
epoch/step/time combination the runner uses for eval and save."""

import dataclasses
import time
from typing import Optional


@dataclasses.dataclass
class FrequencyControl:
    """Fires when the steps counted since the last firing reach
    ``frequency_steps`` or the seconds since it reach
    ``frequency_seconds`` (either None to disable it)."""

    frequency_steps: Optional[int] = None
    frequency_seconds: Optional[float] = None

    def __post_init__(self):
        self._last_time = time.monotonic()
        self._steps = 0

    def check(self, steps: int = 1) -> bool:
        self._steps += steps
        now = time.monotonic()
        hit = (self.frequency_steps is not None
               and self._steps >= self.frequency_steps)
        hit |= (self.frequency_seconds is not None
                and now - self._last_time >= self.frequency_seconds)
        if hit:
            self._last_time = now
            self._steps = 0
        return hit


@dataclasses.dataclass
class EpochStepTimeFreqCtl:
    """Fires on every ``freq_epoch`` epochs, ``freq_step`` global steps
    or ``freq_sec`` seconds, whichever comes first."""

    freq_epoch: Optional[int] = None
    freq_step: Optional[int] = None
    freq_sec: Optional[float] = None

    def __post_init__(self):
        self._epoch_ctl = FrequencyControl(frequency_steps=self.freq_epoch)
        self._step_ctl = FrequencyControl(frequency_steps=self.freq_step)
        self._time_ctl = FrequencyControl(frequency_seconds=self.freq_sec)

    def check(self, epochs: int, steps: int) -> bool:
        # all three are evaluated so their counters advance together
        e = self._epoch_ctl.check(epochs) if self.freq_epoch is not None \
            else False
        s = self._step_ctl.check(steps) if self.freq_step is not None \
            else False
        t = self._time_ctl.check() if self.freq_sec is not None else False
        return e or s or t
