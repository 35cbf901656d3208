"""Gauss-Laguerre quadrature for the Bernstein/Laplace linearization.

The spherical Yat-kernel admits the integral representation (paper Eq. 8):

    E_sph(x) = x^2 / (C - 2x) = \\int_0^inf e^{-sC} [x^2 e^{2sx}] ds,
    x = q^T k in [-1, 1],  C = 2 + eps.

With t = C s this is a standard Gauss-Laguerre integral; the R-node rule
uses s_r = t_r / C and w_r = alpha_r / C. numpy only (float64); a copy of
``repro.core.quadrature`` so the port imports nothing of the JAX package.
"""
from __future__ import annotations

import functools

import numpy as np


@functools.lru_cache(maxsize=64)
def laguerre_nodes(num_nodes: int) -> tuple[np.ndarray, np.ndarray]:
    """Classical Gauss-Laguerre nodes/weights for ∫ e^{-t} f(t) dt."""
    t, a = np.polynomial.laguerre.laggauss(num_nodes)
    return np.asarray(t, dtype=np.float64), np.asarray(a, dtype=np.float64)


def yat_quadrature(num_nodes: int, eps: float) -> tuple[np.ndarray, np.ndarray]:
    """Scaled nodes/weights (s_r, w_r) for the spherical Yat integral.

    Returns float64 numpy arrays; the weights absorb the 1/C Jacobian.
    """
    if num_nodes < 1:
        raise ValueError("num_nodes must be >= 1")
    if eps <= 0:
        raise ValueError("eps must be > 0 (Bernstein applicability, Lemma 1)")
    c = 2.0 + eps
    t, a = laguerre_nodes(num_nodes)
    return t / c, a / c
