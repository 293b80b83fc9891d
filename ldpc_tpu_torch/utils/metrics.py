"""Metrics registry and throughput counters (counterpart of ``ldpc_tpu.utils.metrics``).

Named counters, gauges and series with JSON export, plus the decoded-bits/s
helper for the headline throughput metric.
"""
from __future__ import annotations

import json
import time
from collections import defaultdict
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any


@dataclass
class MetricsRegistry:
    """Process-local named metrics: counters, gauges, and timings."""

    counters: dict[str, float] = field(default_factory=lambda: defaultdict(float))
    gauges: dict[str, float] = field(default_factory=dict)
    series: dict[str, list[float]] = field(default_factory=lambda: defaultdict(list))

    def count(self, name: str, value: float = 1.0) -> None:
        self.counters[name] += float(value)

    def gauge(self, name: str, value: float) -> None:
        self.gauges[name] = float(value)

    def record(self, name: str, value: float) -> None:
        self.series[name].append(float(value))

    def timer(self, name: str) -> "_Timer":
        return _Timer(self, name)

    def snapshot(self) -> dict[str, Any]:
        return {
            "counters": dict(self.counters),
            "gauges": dict(self.gauges),
            "series": {k: list(v) for k, v in self.series.items()},
        }

    def dump(self, path: str | Path) -> None:
        Path(path).write_text(json.dumps(self.snapshot(), indent=2))

    def summary(self) -> str:
        lines = [f"{k}: {v:g}" for k, v in sorted(self.counters.items())]
        lines += [f"{k}: {v:g}" for k, v in sorted(self.gauges.items())]
        for k, v in sorted(self.series.items()):
            if v:
                lines.append(f"{k}: n={len(v)} last={v[-1]:g} mean={sum(v) / len(v):g}")
        return "\n".join(lines)


class _Timer:
    def __init__(self, reg: MetricsRegistry, name: str):
        self.reg, self.name = reg, name

    def __enter__(self):
        self.t0 = time.time()
        return self

    def __exit__(self, *a):
        self.reg.record(self.name + "_s", time.time() - self.t0)
        return False


REGISTRY = MetricsRegistry()


def decode_throughput(num_frames: int, frame_bits: int, seconds: float,
                      registry: MetricsRegistry = REGISTRY,
                      name: str | None = None) -> float:
    """Record and return decoded bits/s.

    ``name`` namespaces the gauge (e.g. ``minsum`` -> ``minsum_bits_per_s``)
    so one registry can hold several decoders.
    """
    bps = num_frames * frame_bits / max(seconds, 1e-12)
    registry.gauge(f"{name}_bits_per_s" if name else "decoded_bits_per_s", bps)
    registry.count("decoded_frames", num_frames)
    registry.count("decoded_bits", num_frames * frame_bits)
    return bps
