"""The traced part of a ``--trace 1`` run: ``torch.profiler`` over a few
units of the window, the shapes of each K1 and K2 launch in it, and what
the trace says: device busy time, kernel time by name, the longest idle
gaps by the benchmark span the host was in.

Device time is the union of the intervals in which a kernel, copy or
memset ran, within the traced window (the benchmark's ``pvsbench.traced``
span). K1's and K2's launches are recorded by wrapping the program's two
launch functions (``ops/segment_kernels.py``) for the traced units only:
each record keeps a view of the launch's row offsets, whose last entry is
the count of real edges the kernel reads, and reads it after the window.
"""
from __future__ import annotations

import torch

WINDOW_SPAN = 'pvsbench.traced'
KERNELS = {'k1': 'segment_sum_sorted_kernel',
           'k2': 'softmax_aggregate_sorted_kernel'}


class LaunchRecorder:
    """Records (real-edge count, rows, width) of every CUDA launch of K1
    and K2 while installed."""

    def __init__(self):
        self.launches = {'k1': [], 'k2': []}
        self._saved = None

    def install(self):
        from pointvs_tpu_torch.ops import segment_kernels as sk
        k1, k2 = sk.windowed_segment_sum, sk.fused_softmax_aggregate
        self._saved = (k1, k2)

        def real_of(ids, n, offsets):
            # The last offset is the first padding edge; without offsets
            # the ids are kept and counted after the window.
            return (offsets[n:n + 1] if offsets is not None
                    else ('ids', ids))

        def rec_k1(data, sorted_ids, num_segments, offsets=None):
            out = k1(data, sorted_ids, num_segments, offsets)
            if data.is_cuda:
                self.launches['k1'].append(
                    (real_of(sorted_ids, num_segments, offsets),
                     num_segments, data.shape[1]))
            return out

        def rec_k2(feat, logits, trans, mask, sorted_ids, num_segments,
                   mode='softmax', offsets=None):
            out = k2(feat, logits, trans, mask, sorted_ids, num_segments,
                     mode, offsets)
            if feat.is_cuda:
                self.launches['k2'].append(
                    (real_of(sorted_ids, num_segments, offsets),
                     num_segments, feat.shape[1]))
            return out

        # The program counts its launches on the function its module
        # holds: the wrappers carry the count while they are installed.
        rec_k1.launches, rec_k2.launches = k1.launches, k2.launches
        sk.windowed_segment_sum, sk.fused_softmax_aggregate = rec_k1, rec_k2

    def remove(self):
        from pointvs_tpu_torch.ops import segment_kernels as sk
        if self._saved is not None:
            k1, k2 = self._saved
            k1.launches = sk.windowed_segment_sum.launches
            k2.launches = sk.fused_softmax_aggregate.launches
            sk.windowed_segment_sum, sk.fused_softmax_aggregate = k1, k2
            self._saved = None

    def shapes(self, kernel: str) -> list:
        """[(real edges, rows, width)] of the recorded launches."""
        out = []
        for real, n, k in self.launches[kernel]:
            if isinstance(real, tuple):
                real = int((real[1] < n).sum())
            else:
                real = int(real.item())
            out.append((real, n, k))
        return out


class Tracer:
    """Profiles the units ``[start, start + count)`` of a window."""

    def __init__(self, enabled: bool, start: int, count: int):
        self.enabled = enabled
        self.start, self.stop = start, start + count
        self.prof = None
        self.span = None
        self.recorder = LaunchRecorder()
        self.summary = None

    def needs_more(self, unit: int) -> bool:
        """Whether the window must run unit ``unit`` to finish the trace."""
        return self.enabled and unit < self.stop

    def before(self, unit: int, device) -> None:
        if not self.enabled or unit != self.start:
            return
        from torch.profiler import ProfilerActivity, profile, \
            record_function
        activities = [ProfilerActivity.CPU]
        if device.type == 'cuda':
            activities.append(ProfilerActivity.CUDA)
            torch.cuda.synchronize(device)
        self.prof = profile(activities=activities)
        self.prof.__enter__()
        self.span = record_function(WINDOW_SPAN)
        self.span.__enter__()
        self.recorder.install()

    def after(self, unit: int, device) -> None:
        if self.prof is None or unit != self.stop - 1:
            return
        if device.type == 'cuda':
            torch.cuda.synchronize(device)
        self.recorder.remove()
        self.span.__exit__(None, None, None)
        self.prof.__exit__(None, None, None)
        self.summary = summarise(self.prof.profiler.kineto_results.events())
        self.summary['shapes'] = {k: self.recorder.shapes(k)
                                  for k in KERNELS}
        self.prof = None


def _is_annotation(event) -> bool:
    check = getattr(event, 'is_user_annotation', None)
    if check is not None and check():
        return True
    name = event.name()
    return name.startswith('pvsbench.') or '#' in name


def _union(intervals: list) -> float:
    total, end = 0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def summarise(events) -> dict:
    """busy_s, window_s, device seconds and launches by kernel name, and
    the longest idle gaps by the benchmark span the host was in."""
    window, spans, device = None, [], []
    for e in events:
        name = e.name()
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            # Annotations (record_function ranges, optimizer steps) are
            # mirrored onto the device's timeline; they are not device work.
            if not _is_annotation(e):
                device.append((e.start_ns(), e.end_ns(), name))
        elif name == WINDOW_SPAN:
            window = (e.start_ns(), e.end_ns())
        elif name.startswith('pvsbench.'):
            spans.append((e.start_ns(), e.end_ns(), name))
    if window is None:
        return {'busy_s': 0.0, 'window_s': 0.0, 'by_name': {}, 'gaps': {}}
    lo, hi = window
    inside = [(max(a, lo), min(b, hi), n) for a, b, n in device
              if b > lo and a < hi]
    by_name = {}
    for a, b, name in inside:
        secs, count = by_name.get(name, (0.0, 0))
        by_name[name] = (secs + (b - a) / 1e9, count + 1)
    busy = _union([(a, b) for a, b, _ in inside])
    gaps, end = {}, lo
    for a, b in sorted((a, b) for a, b, _ in inside) + [(hi, hi)]:
        if a > end:
            mid = (a + end) // 2
            owner = min((s for s in spans if s[0] <= mid <= s[1]),
                        key=lambda s: s[1] - s[0], default=None)
            key = owner[2] if owner else 'outside_benchmark_spans'
            gaps[key] = gaps.get(key, 0.0) + (a - end) / 1e9
        end = max(end, b)
    return {'busy_s': busy / 1e9, 'window_s': (hi - lo) / 1e9,
            'by_name': by_name, 'gaps': gaps}


def kernel_seconds(summary: dict, kernel: str) -> tuple:
    """(device seconds, launches) of the kernels whose name holds
    ``KERNELS[kernel]``."""
    secs = count = 0
    for name, (s, c) in summary['by_name'].items():
        if KERNELS[kernel] in name:
            secs += s
            count += c
    return secs, count


def breakdown(summary: dict) -> dict:
    """The ten device operations that took most time and the ten longest
    idle gaps by span, for the result line."""
    merged = {}
    for name, (secs, _) in summary['by_name'].items():
        merged[name[:100]] = merged.get(name[:100], 0.0) + secs
    ops = sorted(merged.items(), key=lambda t: -t[1])
    gaps = sorted(summary['gaps'].items(), key=lambda t: -t[1])
    return {'device_ops': [list(t) for t in ops[:10]],
            'idle_gaps': [list(t) for t in gaps[:10]]}
