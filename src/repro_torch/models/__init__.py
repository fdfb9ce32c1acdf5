"""Model zoo of the port: the decoder-only LM, dense and MoE (``repro.models``)."""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.lm import LM, build_lm


def build_model(cfg: ModelConfig, device: DeviceLike = None, seed: int = 0) -> LM:
    """The model of ``cfg`` with its parameters on ``device`` (``None`` is the card).

    Its normal inits come from a generator on the device seeded with
    ``seed``.  ``device='meta'`` builds every shape and allocates nothing
    (the JAX package's abstract init).  Families not yet ported raise
    ``NotImplementedError``.
    """
    if torch.device(device if device is not None else "cuda").type == "meta":
        return build_lm(cfg, torch.device("meta"))
    dev = resolve_device(device)
    return build_lm(cfg, dev, torch.Generator(device=dev).manual_seed(seed))
