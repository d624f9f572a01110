"""CPU tests of how the port's spans are read (bench_torch/spans.py).

    python -m pytest bench_torch/tests/test_spans.py -q

Hand-made events check the attribution: self and inclusive busy time and
launches by the innermost span open at each launch, host time, the idle
gaps put down to the span open when they began, and the ranges' device
annotations left out of the operations; a profile without spans gives
an empty table. (tests/test_torch_tracing.py reads a real CPU frame's
spans with it.)
"""

from __future__ import annotations

import argparse
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, HERE)
sys.path.insert(0, ROOT)

import spans  # noqa: E402


class Ev:
    """A profiler event as spans.py reads it."""

    def __init__(self, name, start, end, cpu=True, id=0, thread=1,
                 annotation=False):
        from torch.autograd import DeviceType

        self.name, self.id, self.thread = name, id, thread
        self.device_type = DeviceType.CPU if cpu else DeviceType.CUDA
        self.is_async = False
        self.is_user_annotation = annotation
        self.time_range = argparse.Namespace(start=start, end=end)


def test_spans_attribute_operations_and_idle_gaps():
    # host: frame [0, 100] > shade [10, 80] > trace [20, 40] > kernel
    # [25, 30]; a gc [50, 55] inside shade; the launches (cuda*) tie the
    # device operations to them by id
    cpu = [Ev("wrt.frame", 0, 100), Ev("wrt.shade", 10, 80),
           Ev("wrt.trace", 20, 40), Ev("wrt.trace.kernel", 25, 30),
           Ev("wrt.gc", 50, 55), Ev("bench.frame", 0, 100)]
    cpu += [Ev("cudaLaunchKernel", t, t + 1, id=i)
            for i, t in enumerate((5, 12, 26, 35, 60, 90))]
    dev = [Ev("k_frame", 6, 8, cpu=False, id=0),
           Ev("k_shade", 13, 15, cpu=False, id=1),
           Ev("k_trace", 27, 29, cpu=False, id=2),
           Ev("k_leg", 36, 37, cpu=False, id=3),
           Ev("k_shade2", 61, 71, cpu=False, id=4),
           Ev("k_end", 91, 92, cpu=False, id=5),
           # the ranges' device-side copies are no operations
           Ev("wrt.shade", 13, 71, cpu=False, id=1, annotation=True),
           Ev("wrt.trace", 27, 37, cpu=False, id=2)]
    c, ops, launch_at = spans.device_view(cpu + dev)
    assert [e.name for e in ops] == ["k_frame", "k_shade", "k_trace",
                                     "k_leg", "k_shade2", "k_end"]
    t = spans.span_table(c, ops, launch_at, frames=2)
    half = 0.5  # per frame of 2
    assert t["wrt.trace.kernel"]["self_us"] == 2 * half
    assert t["wrt.trace"]["self_us"] == 1 * half
    assert t["wrt.trace"]["incl_us"] == 3 * half
    assert t["wrt.trace"]["incl_launches"] == 2 * half
    assert t["wrt.shade"]["self_us"] == 12 * half
    assert t["wrt.shade"]["self_launches"] == 2 * half
    assert t["wrt.shade"]["incl_us"] == 15 * half
    assert t["wrt.frame"]["self_us"] == 3 * half
    assert t["wrt.frame"]["incl_launches"] == 6 * half
    assert t["wrt.gc"]["host_us"] == 5 * half
    assert t["wrt.frame"]["host_us"] == 100 * half
    # each gap goes to the innermost span open at its start: 8 -> 13 to
    # the frame, 15 -> 27 and 71 -> 91 to shade, 29 -> 36 to the kernel,
    # 37 -> 61 to the leg
    assert t["wrt.frame"]["idle_us"] == 5 * half
    assert t["wrt.shade"]["idle_us"] == (12 + 20) * half
    assert t["wrt.trace.kernel"]["idle_us"] == 7 * half
    assert t["wrt.trace"]["idle_us"] == 24 * half
    assert [(g, name) for g, _, name in spans.longest_gaps(c, ops, 3)] == [
        (24, "wrt.trace"), (20, "wrt.shade"), (12, "wrt.shade")]


def test_a_nested_span_of_one_name_counts_its_host_time_once():
    cpu = [Ev("wrt.frame", 0, 50), Ev("wrt.trace.sort", 10, 30),
           Ev("wrt.trace.sort", 12, 20), Ev("wrt.trace.sort", 35, 40),
           Ev("cudaLaunchKernel", 15, 16, id=1)]
    dev = [Ev("k", 17, 18, cpu=False, id=1)]
    c, ops, launch_at = spans.device_view(cpu + dev)
    t = spans.span_table(c, ops, launch_at, frames=1)
    assert t["wrt.trace.sort"]["host_us"] == 20 + 5
    assert t["wrt.trace.sort"]["self_launches"] == 1
    assert t["wrt.trace.sort"]["incl_launches"] == 1
    assert t["wrt.frame"]["incl_launches"] == 1


def test_spans_of_a_program_without_them_are_empty():
    cpu = [Ev("bench.frame", 0, 10), Ev("cudaLaunchKernel", 1, 2, id=7)]
    dev = [Ev("k", 3, 4, cpu=False, id=7)]
    c, ops, launch_at = spans.device_view(cpu + dev)
    assert spans.span_table(c, ops, launch_at, 1) == {}
    assert spans.longest_gaps(c, ops) == []
