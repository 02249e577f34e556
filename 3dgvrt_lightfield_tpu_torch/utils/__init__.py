"""Utilities: benchmarking."""

from . import benchmark
from .benchmark import BenchmarkResult, run_benchmark, save_results
