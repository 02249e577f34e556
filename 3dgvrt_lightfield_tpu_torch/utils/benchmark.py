"""Benchmark harness: warmup + timed steady-state loop, fps stats, CSV out.

Port of the reference's benchmark mode (base/benchmark.hpp:30-104, wired via
`-b/-bw/-br/-bf/-bt`, base/VulkanRTBase.cpp:398-415): warmup for `warmup`
seconds, then render until `duration` seconds elapse, report frame count /
fps / best / worst / average, and optionally write per-frame times to CSV.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional


@dataclasses.dataclass
class BenchmarkResult:
    device: str
    runtime_s: float
    frame_count: int
    fps: float
    frame_times_ms: List[float]

    @property
    def best_ms(self) -> float:
        return min(self.frame_times_ms)

    @property
    def worst_ms(self) -> float:
        return max(self.frame_times_ms)

    @property
    def avg_ms(self) -> float:
        return sum(self.frame_times_ms) / len(self.frame_times_ms)


def run_benchmark(render_fn: Callable[[], None], *, warmup: float = 1.0,
                  duration: float = 10.0, output_frames: int = -1,
                  device: str = "", verbose: bool = True) -> BenchmarkResult:
    """Warmup then timed loop (benchmark.hpp:37-75 semantics).

    `render_fn` must block until the frame is done (block_until_ready).
    `output_frames` > 0 caps the number of timed frames (`-bf` flag analog).
    """
    t_measured = 0.0
    while t_measured < warmup:
        t0 = time.perf_counter()
        render_fn()
        t_measured += time.perf_counter() - t0

    runtime = 0.0
    frame_times: List[float] = []
    while runtime < duration:
        t0 = time.perf_counter()
        render_fn()
        dt = (time.perf_counter() - t0) * 1e3
        runtime += dt / 1e3
        frame_times.append(dt)
        if output_frames != -1 and len(frame_times) >= output_frames:
            break

    res = BenchmarkResult(device=device, runtime_s=runtime,
                          frame_count=len(frame_times),
                          fps=len(frame_times) / runtime,
                          frame_times_ms=frame_times)
    if verbose:
        print("Benchmark finished")
        print(f"device : {device}")
        print(f"runtime: {runtime:.3f}")
        print(f"frames : {res.frame_count}")
        print(f"fps    : {res.fps:.3f}")
        print(f"best   : {1e3 / res.best_ms:.3f} fps ({res.best_ms:.3f} ms)")
        print(f"worst  : {1e3 / res.worst_ms:.3f} fps ({res.worst_ms:.3f} ms)")
        print(f"avg    : {1e3 / res.avg_ms:.3f} fps ({res.avg_ms:.3f} ms)")
    return res


def save_results(res: BenchmarkResult, filename: str = "fps.txt",
                 frame_times: bool = True) -> None:
    """CSV output matching benchmark.hpp:77-97."""
    with open(filename, "w") as f:
        f.write("device,duration (ms),frames,fps\n")
        f.write(f"{res.device},{res.runtime_s * 1e3:.4f},{res.frame_count},"
                f"{res.fps:.4f}\n")
        if frame_times:
            f.write("\nframe,ms\n")
            for i, ms in enumerate(res.frame_times_ms):
                f.write(f"{i},{ms:.4f}\n")
