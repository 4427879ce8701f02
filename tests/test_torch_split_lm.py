"""The port's LM split path against the JAX reference: the dense, MoE and
VLM transformers (``LMSplitProgram`` over ``models/split.py``).

For each smoke config (``torch_lm_cases``: qwen3 with qk-norm and tied
embeddings, mixtral's MoE at capacity factor 1.25, internvl2's patches
with -1 labels over them), every OP's ``loss_through_cut`` and its
gradient, with and without the int8 cut, from the reference's params,
against the reference's program (``torch_lm_cases.check_split_program``);
``layer_flops``, ``cut_bytes`` and the OP grid exactly.  The ssm, hybrid
and encdec programs are in ``test_torch_split_recurrent.py``.

Tolerances: losses within 1e-6 relative (observed <= 1.6e-7), every
gradient leaf within 1e-5 of its largest entry (observed <= 1.7e-6).  No
int8 code flips between the two packages at these inputs: a flip would
move the suffix's gradients by one quantization step.
"""
import jax
import jax.numpy as jnp
import pytest
import torch
from torch_lm_cases import check_split_program

from repro.configs import get_smoke_config as j_smoke
from repro.models import api as japi
from repro.models import split as jsplit
from repro_torch import convert
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.configs.qwen3_0_6b import CONFIG as QWEN3
from repro_torch.configs.vgg import VGG5
from repro_torch.models import api as tapi
from repro_torch.models import split as tsplit
from repro_torch.models.split_program import (LMSplitProgram,
                                              get_split_program)


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "mixtral-8x22b",
                                  "internvl2-2b"])
def test_split_program_matches_reference(arch):
    assert check_split_program(arch) <= 1e-5


def test_split_loss_equals_native():
    """The reference's own check (tests/test_fl.py
    test_lm_split_loss_equals_native) on the port: ``split.split_loss`` at
    OPs 0, 1 and L equals ``api.loss`` within 1e-5, on the reference's
    params and tokens."""
    jcfg, tcfg = j_smoke("llama3-8b"), t_smoke("llama3-8b")
    key = jax.random.PRNGKey(0)
    jp = japi.init(jcfg, key, jnp.float32)
    tp = convert.lm_params_from_numpy(jax.tree_util.tree_map(
        lambda a: a.__array__(), jp), device="cpu")
    tokens = jax.random.randint(key, (2, 16), 0, jcfg.vocab_size)
    batch = {"tokens": torch.tensor(tokens.__array__()).long()}
    batch["labels"] = batch["tokens"]
    with torch.no_grad():
        native = float(tapi.loss(tcfg, tp, batch))
        for op in [0, 1, tcfg.num_layers]:
            got = float(tsplit.split_loss(tcfg, tp, batch, op))
            assert abs(got - native) < 1e-5
            want = float(jsplit.split_loss(
                jcfg, jp, {"tokens": tokens, "labels": tokens}, op))
            assert abs(got - want) < 1e-5
    assert tsplit.num_boundaries(tcfg) == jsplit.num_boundaries(jcfg)
    for quant in (False, True):
        assert tsplit.cut_bytes(tcfg, 2, 16, quantize=quant) == \
            jsplit.cut_bytes(jcfg, 2, 16, quantize=quant)


def test_registry_dispatch():
    assert isinstance(get_split_program(QWEN3), LMSplitProgram)
    assert get_split_program(VGG5).cut_bytes(1, 100, None, 4, True) == \
        get_split_program(VGG5).cut_bytes(1, 100, quantize=True)
    with pytest.raises(TypeError, match="unsupported"):
        get_split_program(object())
