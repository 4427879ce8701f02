"""``run_federated`` and ``run_federated_async`` over lm16m (the dense
transformer the reference's batched-engine test trains; rows of 16
tokens) in the port against the JAX package's, from the reference's
initial params (the set-up and bounds of ``tests/torch_fl_cases.py``):

* sync sfl on the batched engine with widths (1.0, 0.5, 0.25) and two
  edges, 3 clients: the reference's batched run, plain fp32 bounds;
* the async runtime (one report a buffer, staleness discount 0.5, 3
  aggregations): plain fp32 bounds;
* a sync run with top-k error feedback checkpointed every round: resumed
  from the port's own round-1 file it equals the unbroken run bit for
  bit; resumed from the reference's file it matches the reference's
  round 2; the port's file reads bitwise in the reference's
  ``restore_tree``.
"""
from repro.configs.lm_small import LM16M as J_LM16M
from repro_torch.configs.lm_small import LM16M
from torch_fl_cases import (check_async, check_batched_widths_edges,
                            check_resume, one_intra_op_thread)

_ = one_intra_op_thread
SEQ = 16


def test_batched_widths_two_edges_match_reference():
    print(check_batched_widths_edges(J_LM16M, LM16M, SEQ))


def test_async_matches_reference():
    print(check_async(J_LM16M, LM16M, SEQ))


def test_resume_is_bitwise_and_reads_both_ways(tmp_path):
    print(check_resume(J_LM16M, LM16M, tmp_path, SEQ))
