"""``run_federated`` over the recurrent and encoder-decoder LM families in
the port against the JAX package's: mamba2 (SSM), recurrentgemma (the
hybrid, 5 layers: one group and two remainder layers) and whisper
(encdec, frames in the client data) smoke configs in sync sfl at the
middle OP with the int8 cut, top-k 0.5 error feedback and int8 deltas,
the checks and bounds of ``tests/test_torch_lm_federated.py``
(``torch_fl_cases.check_sync_discrete``), the same runs in plain fp32
(``check_sync_plain``), and the plain run on the batched engine against
the sequential one (``check_engines_bitwise``): bit for bit, but for
whisper's params, which its remat's two forms put within 1e-6.
"""
import pytest

from torch_fl_cases import (check_engines_bitwise, check_sync_discrete,
                            check_sync_plain, one_intra_op_thread)

_ = one_intra_op_thread
ARCHS = ["mamba2-780m", "recurrentgemma-9b", "whisper-base"]


@pytest.mark.parametrize("arch", ARCHS)
def test_sync_sfl_int8_topk_matches_reference(arch):
    check_sync_discrete(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_sync_sfl_plain_matches_reference(arch):
    check_sync_plain(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_batched_engine_is_sequential_bitwise(arch):
    print(arch, check_engines_bitwise(arch))
