"""Model zoo of the port (``repro.models``): the decoder-only LM (dense, MLA, MoE, VLM,
xLSTM, the Mamba hybrid) and the encoder-decoder."""
from __future__ import annotations

from typing import Callable, Optional, Union

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.encdec import EncDec, build_encdec
from repro_torch.models.lm import LM, build_lm

Model = Union[LM, EncDec]


def build_model(cfg: ModelConfig, device: DeviceLike = None, seed: int = 0,
                place: Optional[Callable] = None) -> Model:
    """The model of ``cfg`` with its parameters on ``device`` (``None`` is the card).

    Its normal inits come from a generator on the device seeded with
    ``seed``.  ``device='meta'`` builds every shape and allocates nothing
    (the JAX package's abstract init).  ``place(value, axes)`` cuts each
    leaf as it is drawn: a rank's blocks on a mesh, the same draws as the
    whole model's.
    """
    build = build_encdec if cfg.family == "encdec" else build_lm
    if torch.device(device if device is not None else "cuda").type == "meta":
        return build(cfg, torch.device("meta"))
    dev = resolve_device(device)
    return build(cfg, dev, torch.Generator(device=dev).manual_seed(seed), place)


def build_on_mesh(cfg: ModelConfig, device: DeviceLike, rules, mesh, seed: int = 0) -> Model:
    """The model of ``cfg`` drawn from ``seed`` on this rank's ``device`` with its
    parameters at rest on ``mesh`` under ``rules``: each leaf drawn whole and cut to its
    block as it goes (the one-device model's draws), then placed
    (``sharding.partition.place_module``)."""
    from repro_torch.sharding import partition as P

    P.check_mesh_family(cfg, mesh)
    model = build_model(cfg, device, seed=seed,
                        place=lambda value, axes: P.cut(value, axes, rules, mesh))
    return P.place_module(model, rules, mesh)
