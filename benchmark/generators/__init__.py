"""Traffic generators, one module per ``kind`` of traffic mix.

A mix file (``traffic/<name>.json``) names its kind; the cell's file
(``cells/<name>.json``) may set further parameters of it, such as the
number of cameras. Each generator's ``run(ctx)`` drives the window and
returns a :class:`Window`.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional


@dataclass
class Frame:
    """One attempted frame. Times are ``time.monotonic()`` seconds:
    ``due`` when it was due to be sent, ``sent`` when it was, and
    ``answered`` when the last datagram (or the future) of its answer
    came; ``msec`` is the answer's in-server time field."""
    slot: int
    due: float
    sent: float
    answered: Optional[float] = None
    msec: Optional[int] = None
    blob: Optional[bytes] = None
    error: Optional[str] = None


@dataclass
class Window:
    t0: float
    t1: float
    deadline_s: float
    frames: List[Frame] = field(default_factory=list)
    before: dict = field(default_factory=dict)   # program counters at t0
    after: dict = field(default_factory=dict)    # and at t1
    spans: dict = field(default_factory=dict)    # program spans, t0 to t1
    trace: Optional[object] = None               # tracing.Trace

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0

    def ok(self, f: Frame) -> bool:
        """Answered, without error, within the deadline of its due time."""
        return (f.answered is not None and f.error is None
                and f.blob is not None
                and f.answered - f.due <= self.deadline_s)

    def answered_in_window(self) -> int:
        return sum(1 for f in self.frames
                   if self.ok(f) and self.t0 <= f.answered < self.t1)
