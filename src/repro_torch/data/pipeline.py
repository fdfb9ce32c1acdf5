"""Synthetic domain-adaptation data (numpy), as ``repro.data.pipeline``.

Only the two-domain generator is ported: it makes the inputs of the paper's
experiments and of ``chip_smoke.py``.  Same seed, same arrays as the JAX
package.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class DomainPairConfig:
    """Two feature domains with shared class structure (paper's DA setup)."""

    num_classes: int = 10
    samples_per_class: int = 10
    dim: int = 2
    shift: float = 5.0
    seed: int = 0


def make_domain_pair(cfg: DomainPairConfig):
    """Paper-synthetic: class means (l*shift, -shift) vs (l*shift, +shift).

    Returns ``(Xs (m, dim) f32, labels (m,), Xt (m, dim) f32, labels)``.
    """
    rng = np.random.default_rng(cfg.seed)
    L, g = cfg.num_classes, cfg.samples_per_class
    m = L * g
    labels = np.repeat(np.arange(L), g)
    mean_s = np.stack([labels * cfg.shift, -cfg.shift * np.ones(m)], axis=1)
    mean_t = np.stack([labels * cfg.shift, +cfg.shift * np.ones(m)], axis=1)
    pad = cfg.dim - 2
    if pad > 0:
        mean_s = np.concatenate([mean_s, np.zeros((m, pad))], axis=1)
        mean_t = np.concatenate([mean_t, np.zeros((m, pad))], axis=1)
    Xs = rng.normal(size=(m, cfg.dim)) + mean_s
    Xt = rng.normal(size=(m, cfg.dim)) + mean_t
    return Xs.astype(np.float32), labels, Xt.astype(np.float32), labels.copy()
