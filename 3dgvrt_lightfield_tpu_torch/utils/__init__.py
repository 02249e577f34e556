"""Utilities: benchmarking and image-quality metrics."""

from . import benchmark, metrics
from .benchmark import BenchmarkResult, run_benchmark, save_results
from .metrics import psnr, ssim
