"""The port's sharding rules against the reference's: the six resolver
tests of tests/test_sharding.py on a real (2, 2) port mesh (names and
sizes, no devices), and every parameter's spec and the dropped set of
all ten archs at full width on both production meshes, held equal to
the reference's ``spec_for`` on a stand-in mesh of the same shape."""
from __future__ import annotations

import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.launch.specs import abstract_params as j_abstract  # noqa: E402
from repro.sharding import specs as j_specs  # noqa: E402
from repro.types import is_param as j_is_param  # noqa: E402
from repro_torch.configs import ARCHS, get_config  # noqa: E402
from repro_torch.launch.mesh import (  # noqa: E402
    Mesh,
    make_mesh,
    make_production_mesh,
)
from repro_torch.launch.specs import abstract_params  # noqa: E402
from repro_torch.sharding import (  # noqa: E402
    DEFAULT_ACT_RULES,
    DEFAULT_PARAM_RULES,
    AxisRules,
    activate_rules,
    active_rules,
    logical_constraint,
    param_shardings,
    spec_for,
)
from repro_torch.sharding.local import on_local_shards  # noqa: E402
from repro_torch.types import Param, is_param, tree_flatten  # noqa: E402


def _mesh2x2() -> Mesh:
    return make_mesh((2, 2), ("data", "model"))


# --------------------------------------------------------------------------
# twins of tests/test_sharding.py, on a real 2 x 2 mesh
# --------------------------------------------------------------------------
def test_divisible_dims_shard():
    with activate_rules(_mesh2x2()):
        assert spec_for((8, 16), ("embed", "mlp")) == ("data", "model")


def test_indivisible_dim_drops_axis():
    with activate_rules(_mesh2x2()) as rules:
        # 7 is not divisible by any axis size > 1 -> dropped, recorded
        spec = spec_for((7, 16), ("heads", "mlp"))
        assert spec[0] is None
        assert ("heads", "model", 7) in rules.dropped


def test_axis_used_once_per_array():
    """Two dims mapping to the same mesh axis: only the first gets it."""
    with activate_rules(_mesh2x2()):
        spec = spec_for((16, 16), ("mlp", "heads"))  # both -> model
        assert spec == ("model",)


def test_overrides_win():
    with activate_rules(_mesh2x2(), {"act_seq": ("model",)}):
        spec = spec_for((4, 16, 8), ("act_batch", "act_seq", "act_embed"))
        assert spec[1] == "model"


def test_multi_axis_composition():
    """A logical axis listing several mesh axes composes them in order."""
    mesh = _mesh2x2()
    with activate_rules(mesh, {"act_batch": ("data", "model")}):
        assert spec_for((mesh.size * 2,), ("act_batch",)) \
            == (("data", "model"),)


def test_param_trees_resolve():
    with activate_rules(_mesh2x2()):
        tree = {"w": Param(torch.zeros((8, 16)), ("embed", "mlp")),
                "b": Param(torch.zeros((16,)), ("mlp",))}
        assert param_shardings(tree) == {"w": ("data", "model"),
                                         "b": ("model",)}


# --------------------------------------------------------------------------
# parity with the reference's resolver at full width
# --------------------------------------------------------------------------
def test_rule_tables_are_the_references():
    assert DEFAULT_PARAM_RULES == j_specs.DEFAULT_PARAM_RULES
    assert DEFAULT_ACT_RULES == j_specs.DEFAULT_ACT_RULES


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_match_reference(arch, multi_pod):
    mesh = make_production_mesh(multi_pod=multi_pod)
    assert mesh.device_mesh is None          # no process group here
    stand_in = types.SimpleNamespace(
        axis_names=mesh.axis_names,
        devices=np.empty(mesh.shape, dtype=object))
    rules = dict(j_specs.DEFAULT_PARAM_RULES)
    rules.update(j_specs.DEFAULT_ACT_RULES)
    j_rules = j_specs.AxisRules(mesh=stand_in, rules=rules)
    j_leaves = jax.tree.leaves(j_abstract(j_get_config(arch)),
                               is_leaf=j_is_param)
    t_leaves = tree_flatten(abstract_params(get_config(arch)),
                            is_leaf=is_param)[0]
    assert len(t_leaves) == len(j_leaves)
    with activate_rules(mesh) as t_rules:
        for jp, tp in zip(j_leaves, t_leaves):
            assert tuple(tp.value.shape) == tuple(jp.value.shape)
            assert tp.axes == jp.axes
            want = tuple(j_specs.spec_for(jp.value.shape, jp.axes, j_rules))
            assert spec_for(tp.value.shape, tp.axes) == want
    assert t_rules.dropped == j_rules.dropped


# --------------------------------------------------------------------------
# no rules, plain tensors: nothing changes
# --------------------------------------------------------------------------
def test_constraint_and_local_call_pass_plain_tensors_through():
    x = torch.arange(12.0).reshape(3, 4)
    assert active_rules() is None
    assert logical_constraint(x, "act_batch", None) is x
    with activate_rules(_mesh2x2()):
        assert logical_constraint(x, "act_batch", None) is x
    assert torch.equal(on_local_shards(lambda a, b: a + b, (x, x),
                                       ((0,), (0,)), ((0,),)), x + x)


def test_rules_nest_and_restore():
    with activate_rules(_mesh2x2()) as outer:
        with activate_rules(_mesh2x2(), {"cache_seq": ("model",)}) as inner:
            assert active_rules() is inner
            assert inner.rules["cache_seq"] == ("model",)
        assert active_rules() is outer
    assert active_rules() is None
    assert isinstance(outer, AxisRules)
