"""The port's config registry against the reference's: the ten
architectures (full and smoke configs) field for field with their analytic
parameter counts, the four input shapes, and the 40-cell matrix."""
import dataclasses

import pytest

from repro.configs import registry as R
from repro.configs import base as JB
from repro_torch import configs as C


def test_arch_names_equal_reference():
    assert C.ARCH_NAMES == R.ARCH_NAMES


@pytest.mark.parametrize("name", R.ARCH_NAMES)
@pytest.mark.parametrize("smoke", [False, True])
def test_config_equals_reference(name, smoke):
    get_mine = C.get_smoke_config if smoke else C.get_config
    get_ref = R.get_smoke_config if smoke else R.get_config
    mine, ref = get_mine(name), get_ref(name)
    assert type(mine).__module__ == "repro_torch.configs.base"
    assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
    assert mine.param_count() == ref.param_count()
    assert mine.active_param_count() == ref.active_param_count()
    assert (mine.q_dim, mine.kv_dim) == (ref.q_dim, ref.kv_dim)
    assert [mine.layer_kind(i) for i in range(mine.num_layers)] == \
        [ref.layer_kind(i) for i in range(ref.num_layers)]


def test_shapes_equal_reference():
    assert list(C.SHAPES) == list(JB.SHAPES)
    for name, shape in C.SHAPES.items():
        assert dataclasses.asdict(shape) == dataclasses.asdict(JB.SHAPES[name])
        assert shape.tokens == JB.SHAPES[name].tokens
        assert C.get_shape(name) == shape


def test_cells_equal_reference():
    mine = [(m.name, s.name, ok, why) for m, s, ok, why in C.all_cells()]
    ref = [(m.name, s.name, ok, why) for m, s, ok, why in R.all_cells()]
    assert mine == ref and len(mine) == 40
    assert [(m.name, s.name) for m, s in C.runnable_cells()] == \
        [(m.name, s.name) for m, s in R.runnable_cells()]
    assert C.matrix_summary() == R.matrix_summary()
    for m, s, _, _ in C.all_cells():
        assert C.cell_is_runnable(m, s) == JB.cell_is_runnable(
            R.get_config(m.name), JB.SHAPES[s.name])


def test_unknown_arch_raises():
    with pytest.raises(KeyError, match="unknown arch"):
        C.get_config("gpt-2")
