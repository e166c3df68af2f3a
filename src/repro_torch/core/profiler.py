"""Profiler → per-worker cost models feeding the scheduler (paper §3.4).

The profiler measures each component's execution time and memory at a few
batch granularities and fits

    t(batch, devices) = base + slope · batch / devices        (SPMD workers)
    t(batch, devices) = base + slope · batch / instances      (replicated)

Simulators (Fig. 3a/3b) are captured by the same form: runtime nearly flat
in the number of environments (slope ≈ 0, large base), memory linear.

A copy of the JAX package's ``core/profiler.py``; only its imports
differ.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np


@dataclass
class CostModel:
    name: str
    base_time: float = 0.0  # s, per-invocation overhead
    slope_time: float = 0.0  # s per item per device
    base_mem: float = 0.0  # bytes
    mem_per_item: float = 0.0  # bytes per item
    onload_time: float = 0.0
    offload_time: float = 0.0
    # measured weight-sync cost (comm.resharding.timed_weight_sync): the
    # seconds/bytes this worker pays to refresh trainer weights when it
    # comes (back) online — charged with its onload on a Temporal cut.
    # 0 for workers that never receive synced weights.
    sync_time: float = 0.0
    sync_bytes: float = 0.0
    scalable: bool = True  # time /devices (SPMD); else replication-only
    min_devices: int = 1
    max_useful_devices: int = 10**9
    # long-tail multiplier for generation-like workers (paper Fig. 2):
    # a FULL-batch stage takes tail_factor × the mean-throughput time
    # (devices idle while the slowest responses finish).  When the stage is
    # chunked for pipelining, each chunk exposes only its share of the tail
    # (continuous-batching semantics: finished responses leave the batch,
    # downstream work overlaps the stall) — so the tail term scales with
    # `frac`, the chunk's fraction of the total batch.
    tail_factor: float = 1.0
    # serve cache layout the records were measured under ("paged-kv",
    # "paged-kv-moe", "state", ...): per-token cost curves differ by
    # layout (KV-gather attention vs constant-size state update), so a
    # fit is only transferable between workers serving the same layout
    layout: str = ""

    def time(self, batch: float, devices: int, frac: float = 1.0) -> float:
        d = max(min(devices, self.max_useful_devices), self.min_devices)
        if not self.scalable:
            d = min(d, self.max_useful_devices)
        per = self.slope_time * batch / d
        tail = per * (self.tail_factor - 1.0) * frac
        return self.base_time + per + max(tail, 0.0)

    def memory(self, batch: float) -> float:
        return self.base_mem + self.mem_per_item * batch

    def switch_cost(self) -> float:
        return self.onload_time + self.offload_time


class Profiler:
    """Measures callables at several granularities and fits CostModels."""

    def __init__(self, *, warmup: int = 1, repeats: int = 2):
        self.warmup = warmup
        self.repeats = repeats
        self.records: Dict[str, List[Tuple[int, float]]] = {}

    def measure(self, name: str, fn: Callable[[int], Any],
                batch_sizes: Sequence[int]) -> CostModel:
        pts: List[Tuple[int, float]] = []
        for b in batch_sizes:
            for _ in range(self.warmup):
                fn(b)
            ts = []
            for _ in range(self.repeats):
                t0 = time.perf_counter()
                fn(b)
                ts.append(time.perf_counter() - t0)
            pts.append((b, min(ts)))
        self.records[name] = pts
        return self.fit(name, pts)

    @staticmethod
    def fit(name: str, pts: Sequence[Tuple[int, float]],
            **kw) -> CostModel:
        xs = np.array([p[0] for p in pts], dtype=np.float64)
        ys = np.array([p[1] for p in pts], dtype=np.float64)
        if len(pts) >= 2 and np.ptp(xs) > 0:
            slope, base = np.polyfit(xs, ys, 1)
            slope = max(float(slope), 0.0)
            base = max(float(base), 0.0)
        else:
            base, slope = float(ys.mean()), 0.0
        return CostModel(name=name, base_time=base, slope_time=slope, **kw)


def fit_tail_factor(service_times: Sequence[float]) -> float:
    """Measured long-tail multiplier from per-request completion times.

    A static-batched stage lasts as long as its slowest request while
    useful throughput tracks the mean, so the stall multiplier is
    ``max / mean`` (same definition as
    ``benchmarks.common.tail_factor_from_lengths``, but measured from an
    engine's request log instead of assumed from a length model).
    """
    arr = np.asarray(list(service_times), dtype=np.float64)
    arr = arr[arr > 0]
    if arr.size == 0 or arr.mean() <= 0:
        return 1.0
    return float(arr.max() / arr.mean())


def engine_cost_model(name: str,
                      records: Sequence[Tuple[int, float]],
                      **kw) -> CostModel:
    """Fit a CostModel from a serving engine's per-request records.

    ``records``: (tokens_generated, service_seconds) per completed
    request, e.g. ``PagedEngine.pop_request_records()``.  base/slope
    come from the tokens-vs-time fit; ``tail_factor`` is *measured* from
    the completion-time spread rather than assumed.
    """
    recs = [(int(n), float(t)) for n, t in records if t > 0]
    if not recs:
        return CostModel(name=name, **kw)
    cm = Profiler.fit(name, recs, **kw)
    cm.tail_factor = fit_tail_factor([t for _, t in recs])
    return cm


def measure_onoffload(worker) -> Tuple[float, float]:
    """Time a real offload/onload round-trip of a worker's state."""
    t0 = time.perf_counter()
    worker.offload()
    t_off = time.perf_counter() - t0
    t0 = time.perf_counter()
    worker.onload()
    t_on = time.perf_counter() - t0
    return t_on, t_off


# ---------------------------------------------------------------------------
# Reference analytic profiles mirroring the paper's measurements — used by
# the event-simulator benchmarks (Figs. 2, 3, 8–13 analogues).
# ---------------------------------------------------------------------------
def paper_like_profiles(*, gen_tail: float = 8.0) -> Dict[str, CostModel]:
    """Shapes (not absolute values) follow the paper:
      generation: memory-bandwidth bound, long-tailed, scales with devices
      inference:  prefill-only, compute bound, cheaper than generation
      training:   ~1/3 of generation time (§2.2), heavy memory
      simulator:  runtime ~flat in #envs, low utilization, memory linear
      reward:     trivial rule-based
    """
    return {
        "rollout": CostModel("rollout", base_time=0.5, slope_time=0.04,
                             base_mem=30e9, mem_per_item=40e6,
                             onload_time=2.0, offload_time=1.5,
                             tail_factor=gen_tail),
        "inference": CostModel("inference", base_time=0.2, slope_time=0.008,
                               base_mem=25e9, mem_per_item=15e6,
                               onload_time=1.5, offload_time=1.0),
        "training": CostModel("training", base_time=0.8, slope_time=0.013,
                              base_mem=60e9, mem_per_item=25e6,
                              onload_time=3.0, offload_time=2.5),
        "simulator": CostModel("simulator", base_time=1.2, slope_time=0.0008,
                               base_mem=2e9, mem_per_item=50e6,
                               onload_time=0.5, offload_time=0.4,
                               scalable=False, max_useful_devices=8),
        "reward": CostModel("reward", base_time=0.02, slope_time=1e-4,
                            base_mem=1e8, mem_per_item=1e4),
    }
