"""The port's LM split path against the JAX reference: the SSM
(``SSMSplitProgram``, mamba2), hybrid (``HybridSplitProgram``,
recurrentgemma at 5 layers: the cut between super-blocks, the remainder
riding the last unit) and encoder-decoder (``EncDecSplitProgram``, whisper:
the payload is the decoder's activations and the encoder's output, both
quantized at the int8 cut) programs, at every OP with and without the
int8 cut (``torch_lm_cases.check_split_program``).

Tolerances: losses within 1e-6 relative (observed <= 1.5e-7), every
gradient leaf within 1e-5 of its largest entry (observed <= 2.4e-6).
"""
import pytest
from torch_lm_cases import check_split_program


@pytest.mark.parametrize("arch", ["mamba2-780m", "recurrentgemma-9b",
                                  "whisper-base"])
def test_split_program_matches_reference(arch):
    assert check_split_program(arch) <= 1e-5
