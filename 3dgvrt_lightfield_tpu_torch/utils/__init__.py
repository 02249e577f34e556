"""Utilities: benchmarking, image-quality metrics, evaluation, profiling and
finite-value checks."""

from . import benchmark, debug, evaluate, metrics, profiling
from .debug import assert_finite, checked
from .profiling import FrameTimer, device_sync, trace
from .benchmark import BenchmarkResult, run_benchmark, save_results
from .evaluate import evaluate_dirs, render_eval_set, save_hit_counts
from .metrics import psnr, ssim
