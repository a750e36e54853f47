"""One train step of the reduced MoE (grok-1, Arctic's dense + MoE),
hybrid (jamba) and cross-attention (llama-3.2-vision, gates at 0.5)
configs on the CPU, from the JAX state carried across, against the jitted
JAX step on the same numpy batch: loss, ce, aux, grad norm, every
parameter and the first moments, at the bounds of
``torch_train_parity``.  The MoE configs route continuously (every expert
chosen, no token dropped): top-k routing is discontinuous, so at their
configured routing a near tie sends a token elsewhere in one package
(``torch_lm_parity``).  Kept apart from ``test_torch_train.py`` because
the JAX step of each of these configs takes 9-26 s to compile.
"""
import pytest

import torch_train_parity as TP
from torch_lm_parity import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("arch", TP.KIND_ARCHS)
def test_train_step_matches_jax(arch):
    TP.check_family_step(arch)
