"""Named spans of the host's time in ``torch.profiler``'s trace.

``span(name)`` is ``torch.profiler.record_function(name, args)`` while the
profiler records, so the span lands in the same Chrome trace as the card's
kernels and runtime calls, on the same clock (``SeamlessClone.profile`` or
any caller's profiler). Otherwise it is one shared no-op context, after a
check that costs well under a microsecond: a ``record_function`` entered
with no profiler running costs over ten. Spans nest on the calling thread,
so each span's parent is the span open around it. Every span of the port
goes through here (``PERF.md`` §3 lists them).
"""

from __future__ import annotations

import contextlib

import torch
from torch.profiler import record_function

_OFF = contextlib.nullcontext()
_recording = torch._C._autograd._profiler_enabled


def span(name: str, args: str | None = None):
    """A context naming the host's time inside it ``name`` in a profile;
    ``args`` rides along to ``record_function``."""
    if _recording():
        return record_function(name, args)
    return _OFF
