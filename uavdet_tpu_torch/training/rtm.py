"""The RTMUAVDet train step: the JAX package's cfg5 (``bench.py:192-233``),
unfolded.

One step takes a batch of frames and its target boxes: ``preprocess`` to
the compute dtype, the forward in train mode under ``steps.autocast`` over
float32 parameters (the BatchNorm statistics update; dropout's masks come
from the step's own generator), ``rtm_compute_loss`` in float32, the
backward and one Adam update (``optim.update``). ``rtm_optimizer`` is
``optax.adam(1e-4)``, optax's defaults, through ``optim.build_optimizer``.
The JAX package's folded variant (``fold_rtm_train_apply``) is a TPU layout
rewrite and is not ported. No kernel runs in a step: the NMS kernel has no
part in training, and no kernel has a backward.
"""

from types import SimpleNamespace
from typing import Sequence

import torch
from torch import nn

from ..inference import preprocess
from ..models.rtm_uav_det import rtm_compute_loss
from ..utils.datatypes import TrainState
from .optim import build_optimizer, update
from .steps import autocast

RTM_HPARAMS = SimpleNamespace(lr=1e-4, lr_scheduler=False,
                              optim=SimpleNamespace(name="Adam"))


def rtm_optimizer(model: nn.Module) -> tuple:
    """-> (optimizer, scheduler) of ``build_optimizer`` over the model's
    parameters: Adam at lr 1e-4 with optax's defaults (betas 0.9, 0.999,
    eps 1e-8)."""
    return build_optimizer(model.parameters(), RTM_HPARAMS)


def make_rtm_train_step(model: nn.Module, optimizer, input_size: int,
                        det_scales: Sequence[int],
                        compute_dtype: torch.dtype = torch.float32):
    """-> ``train_step(images, target_boxes) -> loss`` (a detached float32
    device tensor). ``optimizer``: the (optimizer, scheduler) pair of
    ``rtm_optimizer``; images (B, H, W, 3) uint8 or float in [0, 1],
    target_boxes (B, M, 4) xyxy pixels, both on the model's device. The
    step's ``TrainState`` is ``train_step.state``. Dropout's generator is
    seeded with 0, as the JAX benchmark's dropout key is ``key(0)``."""
    device = next(model.parameters()).device
    state = TrainState(model, *optimizer)
    generator = torch.Generator(device=device).manual_seed(0)

    def train_step(images, target_boxes) -> torch.Tensor:
        model.train()
        x = preprocess(images, input_size, compute_dtype)
        with autocast(device, compute_dtype):
            outs = model(x, generator)
        loss = rtm_compute_loss(outs, target_boxes.float(), input_size,
                                det_scales)
        loss.backward()
        update(state)
        return loss.detach()

    train_step.state = state
    return train_step
