"""repro_torch's train step against repro's, MoE, SSM and hybrid configs.

The counterpart of ``test_torch_train_parity.py`` for grok-1-314b,
arctic-480b (MoE), mamba2-2.7b (SSM) and zamba2-2.7b (hybrid): two train
steps (B 2, L 16, float32) from the reference's initial state. Tolerances:
``test_torch_train_parity.py``.
"""

import pytest

from test_torch_train_parity import one_thread, two_steps  # noqa: F401 (an autouse fixture)

ARCHS = ["grok-1-314b", "arctic-480b", "mamba2-2.7b", "zamba2-2.7b"]


@pytest.mark.parametrize("arch", ARCHS)
def test_two_train_steps_match_reference(arch):
    two_steps(arch, batch=2, seq_len=16)
