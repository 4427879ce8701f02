"""``run_federated`` and ``run_federated_async`` over mamba2's smoke
config (the attention-free SSM; under the batched engine the SSD scan's
Functions run once a client) in the port against the JAX package's, from
the reference's initial params: the checks of
``tests/test_torch_lm_federated_dense.py`` (batched engine with widths
and two edges, async, checkpoint resume) with the set-up and bounds of
``tests/torch_fl_cases.py``.
"""
from repro_torch.configs import registry as TR
from repro.configs import registry as JR
from torch_fl_cases import (check_async, check_batched_widths_edges,
                            check_resume, one_intra_op_thread)

_ = one_intra_op_thread
ARCH = "mamba2-780m"


def test_batched_widths_two_edges_match_reference():
    print(check_batched_widths_edges(JR.get_smoke_config(ARCH),
                                     TR.get_smoke_config(ARCH)))


def test_async_matches_reference():
    print(check_async(JR.get_smoke_config(ARCH), TR.get_smoke_config(ARCH)))


def test_resume_is_bitwise_and_reads_both_ways(tmp_path):
    print(check_resume(JR.get_smoke_config(ARCH), TR.get_smoke_config(ARCH),
                       tmp_path))
