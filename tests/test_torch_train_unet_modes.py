"""rpnet_tpu_torch's training with U-Net mask injection (``mask_feature_map:
x2``) and ``use_relation_enc: concat`` vs the JAX trainer: one SGD step on
the same weights and batch, as ``test_torch_train_breadth.py`` holds the
backbones (its helpers, shapes and tolerances: loss 1e-4 relative, each
tensor's change 10%, running statistics 2e-3 of their scale). A file of
its own so that the suite's workers split the JAX compiles.
"""

import pytest
import torch

from test_torch_train_breadth import check_step

torch.set_num_threads(2)   # small shapes; the suite runs several workers on one machine


@pytest.mark.parametrize("case", ["mask_x2", "concat"])
def test_step_matches_jax(case):
    check_step(case)
