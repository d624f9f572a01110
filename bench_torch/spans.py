"""The port's own spans in a profile, by layer.

The port marks its layers with ``wrt.*`` ranges (its
``utils/timing.span``) while its tracing is on. :func:`device_view`
splits a profile's events into the host events, the device operations
and the host time and thread of each launch (by correlation id);
:func:`span_table` gives each ``wrt.*`` name, per frame:

- ``self_us``, ``self_launches``: the device operations whose innermost
  ``wrt.*`` span open on the launching thread at their launch is this
  one, their busy time and number;
- ``incl_us``, ``incl_launches``: those launched anywhere inside a span
  of this name;
- ``host_us``: the host time of its spans (one inside another of the
  same name counts once);
- ``idle_us``: the device's idle gaps put down to the innermost span
  open on the frames' thread at the instant each gap began (the end of
  the device's last operation before it).

:func:`longest_gaps` names the span each of the longest gaps opened in.
A profile of a program without the spans gives an empty table.
``tools/torch_frame_profile.py`` prints these; a traced run of
``run.py`` reads them once it turns the port's tracing on.
"""

from __future__ import annotations

import bisect

PREFIX = "wrt."
# a name for the idle time and launches outside every span
OUTSIDE = "(outside)"


def device_view(events):
    """(host events, device operations, launch time by correlation id).
    Annotations on the device (the ranges' own device-side copies) are
    not operations."""
    from torch.autograd import DeviceType

    cpu = [e for e in events
           if e.device_type == DeviceType.CPU and not e.is_async]
    ops = [e for e in events
           if e.device_type != DeviceType.CPU
           and not e.is_user_annotation
           and not e.name.startswith(("bench.", PREFIX))]
    launch_at = {e.id: (e.time_range.start, e.thread) for e in cpu
                 if e.name.startswith("cu")}
    return cpu, ops, launch_at


class _Forest:
    """The spans of one thread, nested as their times nest."""

    def __init__(self, spans):
        spans.sort(key=lambda s: (s[0], -s[1]))
        self.start = [s for s, _, _ in spans]
        self.end = [e for _, e, _ in spans]
        self.name = [n for _, _, n in spans]
        self.parent = []
        stack = []
        for i, (s, _, _) in enumerate(spans):
            while stack and self.end[stack[-1]] < s:
                stack.pop()
            self.parent.append(stack[-1] if stack else -1)
            stack.append(i)
        # each span's distinct names up to the root, innermost first
        self.names = []
        for i, p in enumerate(self.parent):
            up = self.names[p] if p >= 0 else ()
            self.names.append((self.name[i],) + tuple(
                n for n in up if n != self.name[i]))

    def inside_its_name(self, i) -> bool:
        """Whether span ``i`` lies inside another span of its name."""
        p = self.parent[i]
        while p >= 0 and self.name[p] != self.name[i]:
            p = self.parent[p]
        return p >= 0

    def at(self, t) -> int:
        """The innermost span open at ``t``, or -1."""
        i = bisect.bisect_right(self.start, t) - 1
        while i >= 0 and self.end[i] < t:
            i = self.parent[i]
        return i


def _forests(cpu):
    """The ``wrt.*`` spans of each thread, and the thread of the frames."""
    by_thread = {}
    for e in cpu:
        if e.name.startswith(PREFIX):
            by_thread.setdefault(e.thread, []).append(
                (e.time_range.start, e.time_range.end, e.name))
    frame_thread = next((e.thread for e in cpu if e.name == "wrt.frame"),
                        next(iter(by_thread), None))
    return {t: _Forest(v) for t, v in by_thread.items()}, frame_thread


def _gaps(ops):
    """The device's idle gaps between its operations: (length, start)."""
    gaps = []
    end = None
    for s, en in sorted((e.time_range.start, e.time_range.end)
                        for e in ops):
        if end is not None and s > end:
            gaps.append((s - end, end))
        end = en if end is None else max(end, en)
    return gaps


def span_table(cpu, ops, launch_at, frames: int) -> dict:
    """The table of the module docstring, keyed by span name, with the
    launches and idle time outside every span under ``OUTSIDE``."""
    forests, frame_thread = _forests(cpu)
    if not forests:
        return {}
    keys = ("self_us", "self_launches", "incl_us", "incl_launches",
            "host_us", "idle_us")
    table = {}

    def row(name):
        if name not in table:
            table[name] = dict.fromkeys(keys, 0.0)
        return table[name]

    for f in forests.values():
        for i, n in enumerate(f.name):
            r = row(n)
            if not f.inside_its_name(i):
                r["host_us"] += f.end[i] - f.start[i]
    for e in ops:
        at = launch_at.get(e.id)
        if at is None:
            continue
        dur = e.time_range.end - e.time_range.start
        f = forests.get(at[1])
        i = f.at(at[0]) if f is not None else -1
        names = f.names[i] if i >= 0 else (OUTSIDE,)
        r = row(names[0])
        r["self_us"] += dur
        r["self_launches"] += 1
        for n in names:
            r = row(n)
            r["incl_us"] += dur
            r["incl_launches"] += 1
    f = forests.get(frame_thread)
    for g, at in _gaps(ops):
        i = f.at(at) if f is not None else -1
        row(f.name[i] if i >= 0 else OUTSIDE)["idle_us"] += g
    n = max(frames, 1)
    return {k: {c: v / n for c, v in r.items()} for k, r in table.items()}


def longest_gaps(cpu, ops, top: int = 5):
    """The ``top`` longest idle gaps of the device: (gap µs, the instant
    it began, the innermost ``wrt.*`` span open then on the frames'
    thread or ``OUTSIDE``), longest first."""
    forests, frame_thread = _forests(cpu)
    f = forests.get(frame_thread)
    out = []
    for g, at in sorted(_gaps(ops), reverse=True)[:top]:
        i = f.at(at) if f is not None else -1
        out.append((g, at, f.name[i] if i >= 0 else OUTSIDE))
    return out
