"""What a run records, and what the metric readers read from it.

`Record` holds the host clock's readings of the measured window (each call
or step), the benchmark's spans around the program's layers (CUDA events
in a traced run), the profiled segment's summary (`trace.Segment`), the
work a call or step needs by kernel, and the FLOPs the reference counts
for it. Readers return None where there is nothing to read, and the run
leaves that metric out of its line."""
from __future__ import annotations

import dataclasses
import statistics
from typing import Dict, List, Optional

from . import peaks
from .spec import work


@dataclasses.dataclass
class Record:
    kind: str                         # the driver: "plan", "train", ...
    dtype: str                        # the configuration's compute dtype
    dims: Dict[str, int]              # views, height, width, channels
    work_rows: Dict[str, int]         # kernel -> rows a call or step needs
    setup_s: float = float("nan")
    window_s: float = 0.0
    latencies_s: List[float] = dataclasses.field(default_factory=list)
    failed: int = 0
    spans_ms: Dict[str, List[float]] = dataclasses.field(default_factory=dict)
    segment: Optional[object] = None  # trace.Segment of a traced run
    flops_per_call: Optional[float] = None

    @property
    def calls(self) -> int:
        return len(self.latencies_s)

    def mean_ms(self) -> Optional[float]:
        return 1e3 * self.window_s / self.calls if self.calls else None

    def percentile_ms(self, q: float) -> Optional[float]:
        if len(self.latencies_s) < 20:
            return None
        cuts = statistics.quantiles(self.latencies_s, n=100,
                                    method="inclusive")
        return 1e3 * cuts[int(q) - 1]

    def span_ms(self, name: str) -> Optional[float]:
        v = self.spans_ms.get(name)
        return statistics.fmean(v) if v else None

    def sound_segment(self):
        """The profiled segment, unless it lost device events."""
        seg = self.segment
        if seg is None or seg.lost or not seg.calls:
            return None
        return seg

    def roofline(self, kernel: str) -> Optional[float]:
        """% of kernel's launches' least time (its work module's bound at
        the rows a call needs) in their device time, over the segment."""
        seg = self.sound_segment()
        if seg is None or self.work_rows.get(kernel) is None:
            return None
        time_s = seg.kernel_s.get(kernel, 0.0)
        calls = seg.counters.get(kernel, 0)
        mod = work(kernel)
        if (not time_s or not calls
                or seg.kernel_launches.get(kernel)
                != calls * mod.cuda_launches()):
            return None
        flops, nbytes, peak = mod.cost(self.work_rows[kernel] * seg.calls,
                                       calls, self.dtype, **self.dims)
        bound = max(flops / peak, nbytes / peaks.HBM_BYTES_PER_S)
        return 100.0 * bound / time_s

    def mfu(self) -> Optional[float]:
        ms = self.mean_ms()
        if self.flops_per_call is None or not ms:
            return None
        return 100.0 * self.flops_per_call / (
            ms * 1e-3 * peaks.FLOPS[self.dtype])
