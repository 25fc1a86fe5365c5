"""Image-parity metrics: PSNR, SSIM and depth-error statistics (numpy
copies of ``rgbd_recon_tpu/utils/metrics.py``, so that a run without JAX,
``chip_smoke.py`` on the card, states render parity by the repo's own
measure). Host numpy over device outputs brought back with ``.cpu()``.
"""
from __future__ import annotations

import numpy as np


def psnr(a: np.ndarray, b: np.ndarray, peak: float = 1.0) -> float:
    """Peak signal-to-noise ratio in dB over all channels."""
    mse = float(np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2))
    if mse == 0.0:
        return float("inf")
    return float(10.0 * np.log10(peak * peak / mse))


def _uniform_filter(x: np.ndarray, k: int) -> np.ndarray:
    """k x k box filter via 2D cumulative sums (valid region only)."""
    c = np.cumsum(np.cumsum(x, axis=0), axis=1)
    c = np.pad(c, ((1, 0), (1, 0)))
    s = c[k:, k:] - c[:-k, k:] - c[k:, :-k] + c[:-k, :-k]
    return s / (k * k)


def ssim(a: np.ndarray, b: np.ndarray, peak: float = 1.0, k: int = 7) -> float:
    """Mean structural similarity (uniform k x k window, C1 = (0.01 L)^2,
    C2 = (0.03 L)^2). Color inputs are averaged over the last axis first."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if a.ndim == 3:
        a = a.mean(axis=-1)
        b = b.mean(axis=-1)
    c1 = (0.01 * peak) ** 2
    c2 = (0.03 * peak) ** 2
    mu_a = _uniform_filter(a, k)
    mu_b = _uniform_filter(b, k)
    var_a = _uniform_filter(a * a, k) - mu_a * mu_a
    var_b = _uniform_filter(b * b, k) - mu_b * mu_b
    cov = _uniform_filter(a * b, k) - mu_a * mu_b
    num = (2 * mu_a * mu_b + c1) * (2 * cov + c2)
    den = (mu_a ** 2 + mu_b ** 2 + c1) * (var_a + var_b + c2)
    return float(np.mean(num / den))


def render_parity(ref, fast) -> dict:
    """Parity stats between two render outputs (anything with color, depth
    and hit): hit agreement, color PSNR / SSIM over the whole image (misses
    are the cleared background in both), window-depth error percentiles
    over the pixels hit in both."""
    hit_r = np.asarray(ref.hit).astype(bool)
    hit_f = np.asarray(fast.hit).astype(bool)
    c_r = np.asarray(ref.color, np.float64)
    c_f = np.asarray(fast.color, np.float64)
    d_r = np.asarray(ref.depth, np.float64)
    d_f = np.asarray(fast.depth, np.float64)
    both = hit_r & hit_f
    dd = np.abs(d_r[both] - d_f[both]) if both.any() else np.zeros(1)
    return {
        "hit_agreement": float(np.mean(hit_r == hit_f)),
        "psnr_rgb": psnr(c_r[..., :3], c_f[..., :3]),
        "ssim_rgb": ssim(c_r[..., :3], c_f[..., :3]),
        "depth_err_med": float(np.median(dd)),
        "depth_err_p99": float(np.percentile(dd, 99)),
        "depth_err_max": float(np.max(dd)),
        "hit_frac": float(np.mean(hit_r)),
    }


def render_parity_passes(s: dict) -> bool:
    """``render_parity`` stats within the render-parity bounds of
    tests/test_golden.py:65-69 (coverage is the caller's to require)."""
    return (s["hit_agreement"] > 0.995 and s["psnr_rgb"] > 30.0 and s["ssim_rgb"] > 0.95
            and s["depth_err_med"] < 2e-3 and s["depth_err_p99"] < 2e-2)
