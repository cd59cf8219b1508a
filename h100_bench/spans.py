"""The device's idle time split by the program's spans.

The program marks its layer boundaries with ``torch.profiler`` ranges named
``pf.*`` (``particle_filters_tpu_torch.utils.timing.span``); a traced run
keeps them among the trace's host events. Each idle gap of the device is cut
at the spans' boundaries, and each piece goes to the innermost span that
covers it (spans nest on the host's one thread), or to no span. So the
idle under every span, plus the idle under none, is the whole idle time.
"""

from __future__ import annotations

import heapq
from collections import Counter

PREFIX = "pf."


def program_spans(trace) -> list:
    """The trace's program spans: ``[(start, end, name)]`` in µs, by start."""
    return sorted((ts, ts + dur, name) for name, ts, dur in trace.host
                  if name.startswith(PREFIX))


def _innermost(spans: list) -> list:
    """The window cut where any span starts or ends: ``[(start, end, name)]``
    for each piece, ``name`` the innermost span covering it (the latest
    started; the shortest of those started together), None where none does."""
    cuts = sorted({t for s, e, _ in spans for t in (s, e)})
    pieces, active, j = [], [], 0
    for a, b in zip(cuts, cuts[1:]):
        while j < len(spans) and spans[j][0] <= a:
            s, e, name = spans[j]
            heapq.heappush(active, (-s, e - s, e, name))
            j += 1
        while active and active[0][2] <= a:
            heapq.heappop(active)
        pieces.append((a, b, active[0][3] if active else None))
    return pieces


def idle_split(trace) -> Counter:
    """Idle seconds of the traced window by the innermost program span the
    host was in (key None: under no span)."""
    pieces = _innermost(program_spans(trace))
    out, i = Counter(), 0
    for g0, g1 in trace.gaps():
        under = 0.0
        while i < len(pieces) and pieces[i][1] <= g0:
            i += 1
        k = i
        while k < len(pieces) and pieces[k][0] < g1:
            a, b, name = pieces[k]
            overlap = min(b, g1) - max(a, g0)
            if overlap > 0 and name is not None:
                out[name] += overlap * 1e-6
                under += overlap
            k += 1
        out[None] += (g1 - g0 - under) * 1e-6
    return out


def idle_by_span(trace, names) -> float | None:
    """100 × the idle seconds whose innermost program span is one of
    ``names``, over the traced window; None where the trace holds no span
    of ``names`` (a program without them)."""
    if trace is None or trace.window_s <= 0:
        return None
    if not any(name in names for _, _, name in program_spans(trace)):
        return None
    split = idle_split(trace)
    return 100.0 * sum(split[name] for name in names) / trace.window_s
