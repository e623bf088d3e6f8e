"""The port's DyYOLO detector at its serving size against the JAX package,
on the CPU: full width, 640 px, batch 1, f32 outside the stem.

The 64 px tests of ``tests/test_torch_detector.py`` hold the same chain at a
size where the tail's feature maps are 2 x 2 to 8 x 8; here the tail runs
at 80 x 80 down to 20 x 20, the grid the card serves. The JAX detector runs
its Pallas stem in interpret mode with the unfolded tail
(``fold_early=False``); the port runs the plain versions of its kernels.
Marked ``slow``: tier-1 leaves it out (``-m 'not slow'``); run it with
``python -m pytest tests/test_torch_parity_640.py -m slow``.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from tests.test_torch_detector import _assert_same_detections
from tests.test_torch_model import models_for
from uavdet_tpu.inference import make_detector as jax_make_detector
from uavdet_tpu_torch.inference import make_detector
from uavdet_tpu_torch.models import DYYOLO

SIZE = 640


@pytest.mark.slow
def test_detector_matches_jax_at_640(rng):
    """uint8 frames at 640 px straight into the stem on both sides, the
    tolerances of ``_assert_same_detections`` (valid equal, scores rtol
    1e-4, boxes within 1e-2 px or trading places with an equal score)."""
    jm, v, port = models_for(tuple(DYYOLO.layer_config), 20)
    x = (rng.uniform(size=(1, SIZE, SIZE, 3)) * 255).astype(np.uint8)
    want = jax_make_detector(
        jm, DYYOLO, SIZE, compute_dtype=jnp.float32, pallas_stem_variables=v,
        pallas_stem_interpret=True, fold_early=False)(v, jnp.asarray(x))
    got = make_detector(port, DYYOLO, SIZE, compute_dtype=torch.float32)(
        torch.from_numpy(x))
    assert got.boxes.shape == (1, 300, 4)
    _assert_same_detections(got, want)
