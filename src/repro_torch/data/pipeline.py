"""Deterministic synthetic data (numpy), as ``repro.data.pipeline``.

Two generators: :class:`SyntheticLM`, the LM token stream of the trainer
(``batch(step)`` a pure function of seed, step and shard, so a restart
resumes on the same data; a Zipf-like marginal with a class-conditioned
drift, so the LM loss falls), and :func:`make_domain_pair`, the inputs of
the paper's experiments and of ``chip_smoke.py``.  Same seed, same arrays
as the JAX package.  :func:`modality_stub` stands in for the stubbed
frontends (audio frames, image tokens), whose shapes alone the JAX
package's ``launch/specs.py`` gives.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np


def modality_stub(cfg, batch: int, seed: int) -> Dict[str, np.ndarray]:
    """The stub frontend's output for a model config ``cfg`` that takes a modality,
    standard normal float32 drawn from ``seed``: an encoder-decoder's frame embeddings
    ``{"frames": (batch, num_audio_frames, d_model)}``, a VLM's image tokens ``{"memory":
    (batch, num_image_tokens, d_model)}``; ``{}`` for the other families."""
    lengths = {"encdec": ("frames", cfg.num_audio_frames),
               "vlm": ("memory", cfg.num_image_tokens)}
    if cfg.family not in lengths:
        return {}
    name, n = lengths[cfg.family]
    rng = np.random.default_rng(seed)
    return {name: rng.standard_normal((batch, n, cfg.d_model), dtype=np.float32)}


@dataclasses.dataclass
class SyntheticLMConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.3
    markov_order: int = 1
    num_classes: int = 8          # for DA mode


class SyntheticLM:
    """batch(step) -> {"tokens": (B, S+1) int32, "class": (B,) int32}."""

    def __init__(self, cfg: SyntheticLMConfig, shard_id: int = 0, num_shards: int = 1):
        if cfg.global_batch % num_shards:
            raise ValueError(f"global_batch {cfg.global_batch} is not a multiple of "
                             f"num_shards {num_shards}")
        self.cfg = cfg
        self.shard_id = shard_id
        self.num_shards = num_shards
        self.local_batch = cfg.global_batch // num_shards
        rng = np.random.default_rng(cfg.seed)
        # fixed random Markov transition biased toward a Zipf marginal
        V = cfg.vocab_size
        ranks = np.arange(1, V + 1)
        self.marginal = (ranks ** -cfg.zipf_a)
        self.marginal /= self.marginal.sum()
        self.shift = rng.integers(1, V, size=cfg.num_classes)

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        rng = np.random.default_rng(
            (cfg.seed * 1_000_003 + step) * 4096 + self.shard_id
        )
        B, S, V = self.local_batch, cfg.seq_len, cfg.vocab_size
        cls = rng.integers(0, cfg.num_classes, size=B).astype(np.int32)
        base = rng.choice(V, size=(B, S + 1), p=self.marginal)
        # class-conditioned deterministic drift: makes next-token partially
        # predictable, so training curves move
        drift = np.cumsum(np.ones((B, S + 1), np.int64), axis=1) * self.shift[cls][:, None]
        tokens = ((base + drift) % V).astype(np.int32)
        # inject strong bigram structure: every even position repeats
        tokens[:, 2::2] = (tokens[:, 1:-1:2] + self.shift[cls][:, None]) % V
        return {"tokens": tokens, "class": cls}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1


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
