"""Utilities: benchmarking, image-quality metrics and evaluation."""

from . import benchmark, evaluate, metrics
from .benchmark import BenchmarkResult, run_benchmark, save_results
from .evaluate import evaluate_dirs, render_eval_set, save_hit_counts
from .metrics import psnr, ssim
