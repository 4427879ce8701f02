"""The port's launch specs (``repro_torch.launch.{steps, inputs, mesh}``
and ``core.costmodel.analytic_step_memory_bytes``) against the JAX
reference's, at full size for every registry config.

The reference's stand-ins come from ``jax.eval_shape`` (``ShapeDtypeStruct``),
the port's are ``meta`` tensors: shapes and dtypes are compared leaf by
leaf under the ``/``-joined path ``tree_flatten_with_path`` gives, specs
as tuples.  The reference's rules read only ``mesh.shape``, so its meshes
here are stubs of the production shapes (16 x 16 and 2 x 16 x 16), and the
port's rules take the same stubs.  The HBM-traffic model is compared with
``==``.
"""
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs import SHAPES as J_SHAPES
from repro.configs import get_config as j_config
from repro.core import costmodel as jcm
from repro.launch import inputs as JI
from repro.launch import mesh as JM
from repro.launch import steps as JS
from repro.optim import make_optimizer as j_make_optimizer
from repro.parallel import sharding as JSH
from repro_torch.configs import ARCH_NAMES, SHAPES, get_config
from repro_torch.core import costmodel as cm
from repro_torch.launch import inputs as I
from repro_torch.launch import mesh as M
from repro_torch.launch import steps as S
from repro_torch.optim.optimizers import make_optimizer
from repro_torch.parallel import sharding as SH

OPTIMIZERS = ("adamw", "sgd", "adafactor")
META = torch.device("meta")


def _stub(pod=0):
    shape = {"data": 16, "model": 16}
    return SimpleNamespace(shape={"pod": pod, **shape} if pod else shape)


def _rules(pod):
    return (SH.make_axis_rules(_stub(pod)), JSH.make_axis_rules(_stub(pod)))


def _j_flat(tree, is_leaf=None):
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(
                tree, is_leaf=is_leaf)[0]}


def _same_shapes(ttree, jtree):
    t, j = SH.path_leaves(ttree), _j_flat(jtree)
    assert sorted(t) == sorted(j)
    for path, leaf in j.items():
        assert leaf.shape == tuple(t[path].shape), path
        assert str(leaf.dtype) == str(t[path].dtype).removeprefix("torch."), \
            path
        assert t[path].device == META, path


def _same_specs(tspecs, jspecs):
    t = SH.path_leaves(tspecs, is_leaf=SH.is_spec)
    j = _j_flat(jspecs, is_leaf=lambda x: isinstance(x, P))
    assert sorted(t) == sorted(j)
    for path, spec in j.items():
        assert t[path] == tuple(spec), (path, t[path], spec)


@pytest.fixture(scope="module", params=ARCH_NAMES)
def cell(request):
    """One config's full-size stand-ins on both sides, with each
    optimizer's state."""
    arch = request.param
    cfg, jcfg = get_config(arch), j_config(arch)
    out = SimpleNamespace(arch=arch, cfg=cfg, jcfg=jcfg,
                          params=S.abstract_params(cfg),
                          jparams=JS.abstract_params(jcfg, jnp.bfloat16))
    out.opt = {name: S.abstract_opt_state(make_optimizer(name), out.params)
               for name in OPTIMIZERS}
    out.jopt = {name: JS.abstract_opt_state(j_make_optimizer(name),
                                            out.jparams)
                for name in OPTIMIZERS}
    return out


def test_abstract_params_and_opt_state_match_reference(cell):
    _same_shapes(cell.params, cell.jparams)
    for name in OPTIMIZERS:
        _same_shapes(cell.opt[name], cell.jopt[name])
    # the config's own optimizer, as make_opt picks it
    assert S.make_opt(cell.cfg).name == JS.make_opt(cell.jcfg).name


@pytest.mark.parametrize("pod", [0, 2])
def test_param_and_opt_pspecs_match_reference(cell, pod):
    trules, jrules = _rules(pod)
    tspecs = S.model_param_pspecs(cell.cfg, cell.params, trules)
    jspecs = JS.model_param_pspecs(cell.jcfg, cell.jparams, jrules)
    _same_specs(tspecs, jspecs)
    for name in OPTIMIZERS:
        _same_specs(S.opt_pspecs(cell.opt[name], cell.params, tspecs, trules),
                    JS.opt_pspecs(cell.jopt[name], cell.jparams, jspecs,
                                  jrules))


@pytest.mark.parametrize("pod", [0, 2])
def test_batch_and_cache_specs_match_reference(cell, pod):
    trules, jrules = _rules(pod)
    for name, shape in SHAPES.items():
        jshape = J_SHAPES[name]
        assert I.text_len(cell.cfg, shape.seq_len) == \
            JI.text_len(cell.jcfg, jshape.seq_len)
        batch = I.train_batch_specs(cell.cfg, shape)
        jbatch = JI.train_batch_specs(cell.jcfg, jshape)
        _same_shapes(batch, jbatch)
        _same_shapes(I.prefill_batch_specs(cell.cfg, shape),
                     JI.prefill_batch_specs(cell.jcfg, jshape))
        _same_specs(I.batch_pspecs(cell.cfg, batch, trules),
                    JI.batch_pspecs(cell.jcfg, jbatch, jrules))
        cache = I.cache_shapes(cell.cfg, shape)
        jcache = JI.cache_shapes(cell.jcfg, jshape)
        _same_shapes(cache, jcache)
        _same_specs(I.cache_pspecs(cell.cfg, cache, trules),
                    JI.cache_pspecs(cell.jcfg, jcache, jrules))
        _, token, pos = I.decode_inputs(cell.cfg, shape)
        _, jtoken, jpos = JI.decode_inputs(cell.jcfg, jshape)
        _same_shapes({"t": token, "p": pos}, {"t": jtoken, "p": jpos})


def test_pod_stacking_matches_reference(cell):
    trules, jrules = _rules(2)
    tspecs = S.model_param_pspecs(cell.cfg, cell.params, trules)
    jspecs = JS.model_param_pspecs(cell.jcfg, cell.jparams, jrules)
    _same_shapes(S.stack_for_pods(cell.params, 2),
                 JS.stack_for_pods(cell.jparams, 2))
    _same_specs(S.pod_pspecs(tspecs, 2), JS.pod_pspecs(jspecs, 2))
    name = cell.cfg.optimizer
    _same_shapes(S.stack_for_pods(cell.opt[name], 2),
                 JS.stack_for_pods(cell.jopt[name], 2))
    _same_specs(
        S.pod_pspecs(S.opt_pspecs(cell.opt[name], cell.params, tspecs,
                                  trules), 2),
        JS.pod_pspecs(JS.opt_pspecs(cell.jopt[name], cell.jparams, jspecs,
                                    jrules), 2))


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_analytic_step_memory_bytes_equals_reference(arch):
    cfg, jcfg = get_config(arch), j_config(arch)
    for kind in ("train", "prefill", "decode"):
        for dp, tp in ((1, 1), (16, 16), (32, 16), (2, 8), (4, 4), (8, 3)):
            for batch, seq, cache_len in ((256, 4096, None), (128, 32768, None),
                                          (1, 524288, 2048), (3, 77, 5)):
                for act_bytes in (2, 4):
                    kw = dict(act_bytes=act_bytes, cache_len=cache_len)
                    assert cm.analytic_step_memory_bytes(
                        cfg, kind, batch, seq, dp, tp, **kw) == \
                        jcm.analytic_step_memory_bytes(
                            jcfg, kind, batch, seq, dp, tp, **kw)


def test_production_mesh_shapes_and_messages():
    mesh = M.make_production_mesh(devices=[META] * 256)
    assert mesh.shape == {"data": 16, "model": 16}
    assert mesh.axis_names == ("data", "model") and mesh.size == 256
    assert mesh.home == META and mesh.n_devices == 1
    multi = M.make_production_mesh(multi_pod=True, devices=[META] * 512)
    assert multi.shape == {"pod": 2, "data": 16, "model": 16}
    assert multi.axis_names == ("pod", "data", "model")
    # the first places of a longer list
    assert M.make_production_mesh(devices=[META] * 512).size == 256
    # too few places: the reference names its XLA flag, the port devices=
    with pytest.raises(RuntimeError, match=r"need 256 places.*devices="):
        M.make_production_mesh(devices=[META] * 255)
    with pytest.raises(RuntimeError, match=r"need 512 places.*devices="):
        M.make_production_mesh(multi_pod=True, devices=[META] * 256)
    if len(jax.devices()) < 256:
        with pytest.raises(RuntimeError, match="need 256 devices"):
            JM.make_production_mesh()
    if not torch.cuda.is_available():
        # the default places on the CPU are one
        with pytest.raises(RuntimeError, match="devices="):
            M.make_production_mesh()


def test_debug_mesh():
    cpu = [torch.device("cpu")] * 8
    assert M.make_debug_mesh(devices=cpu).shape == {"data": 1, "model": 1}
    assert M.make_debug_mesh(2, 4, devices=cpu).shape == {"data": 2,
                                                         "model": 4}
    m = M.make_debug_mesh(2, 2, pod=2, devices=cpu)
    assert m.shape == {"pod": 2, "data": 2, "model": 2}
    with pytest.raises(RuntimeError, match="devices="):
        M.make_debug_mesh(4, 4, devices=cpu)
