"""The port's sharding rules and hints against the reference
(``repro.sharding``), on the CPU; specs are metadata, no mesh is made.

* ``make_ruleset`` equals the reference's for one pod and two, every
  kind, batch divisible or not;
* ``param_spec_tree`` equals the reference's on every LM arch at
  ``reduce_for_smoke``, on one pod's axes and two pods' (the reference's
  ``PartitionSpec`` compared as a tuple), and so does
  ``guard_divisibility`` of those trees on the production meshes' sizes
  and the reference's;
* ``shard_hint`` (and ``sharded_reshape``) return their input outside
  ``logical_rules``, and on a plain tensor inside them.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.config import reduce_for_smoke as jreduce  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import list_configs  # noqa: E402
from repro.models import build_model as jbuild_model  # noqa: E402
from repro.sharding import guard_divisibility as j_guard  # noqa: E402
from repro.sharding import make_ruleset as j_make_ruleset  # noqa: E402
from repro.sharding import param_spec_tree as j_param_spec_tree  # noqa: E402
from repro_torch.config import LM_FAMILIES, reduce_for_smoke  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.sharding import (  # noqa: E402
    guard_divisibility, logical_rules, make_ruleset, param_spec_tree,
    shard_hint, sharded_reshape)
from repro_torch.utils import tree_map  # noqa: E402

LM_ARCHS = [a for a in list_configs() if get_config(a).family in LM_FAMILIES]
AXES = (("data", "model"), ("pod", "data", "model"))
# the port's production meshes and the reference's
SIZES = ({"data": 32, "model": 8}, {"pod": 2, "data": 32, "model": 8},
         {"data": 16, "model": 16}, {"pod": 2, "data": 16, "model": 16})


class FakeMesh:
    """The reference's guard reads axis names and the device grid's
    shape."""

    def __init__(self, sizes):
        self.axis_names = tuple(sizes)
        self.devices = np.empty(tuple(sizes.values()))


def _flat_ref(tree):
    """{path: tuple} of a reference tree of PartitionSpecs (or structs)."""
    from jax.sharding import PartitionSpec
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, PartitionSpec))[0]
    return {tuple(k.key for k in path): leaf for path, leaf in leaves}


def _flat(tree, path=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, path + (k,)))
        return out
    return {path: tree}


def test_rulesets_equal_the_reference():
    for axes in AXES:
        for kind in ("train", "prefill", "decode"):
            for divisible in (True, False):
                assert make_ruleset(axes, kind=kind,
                                    batch_divisible=divisible) == \
                    j_make_ruleset(axes, kind=kind,
                                   batch_divisible=divisible)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_param_specs_and_guard_equal_the_reference(arch):
    jmodel = jbuild_model(jreduce(jget_config(arch)))
    jparams = jax.eval_shape(lambda k: jmodel.init(k),
                             jax.ShapeDtypeStruct((2,), jnp.uint32))
    model = build_model(reduce_for_smoke(get_config(arch)))
    params = tree_map(lambda s, d: torch.empty(s, dtype=d, device="meta"),
                      model.param_shapes(), model.param_dtypes())
    shapes = {p: tuple(t.shape) for p, t in _flat(params).items()}
    assert shapes == {p: tuple(s.shape)
                      for p, s in _flat_ref(jparams).items()}
    for axes in AXES:
        jspec = j_param_spec_tree(jparams, axes)
        spec = param_spec_tree(params, axes)
        want = {p: tuple(s) for p, s in _flat_ref(jspec).items()}
        assert _flat(spec) == want
        for sizes in SIZES:
            if set(sizes) != set(axes):
                continue
            got = _flat(guard_divisibility(spec, params, sizes))
            ref = j_guard(jspec, jparams, FakeMesh(sizes))
            assert got == {p: tuple(s) for p, s in _flat_ref(ref).items()}


def test_guard_drops_axes_that_do_not_divide():
    spec = {"w": ("data", "model")}
    shapes = {"w": torch.empty(24, 32, device="meta")}
    assert guard_divisibility(spec, shapes, {"data": 16, "model": 16}) == \
        {"w": (None, "model")}


def test_hints_noop_without_rules():
    x = torch.ones(4, 4)
    assert shard_hint(x, ("batch", "embed")) is x
    assert torch.equal(sharded_reshape(x, (2, 8)), x.reshape(2, 8))
    # a plain tensor inside the rules is not a DTensor: left as it is
    with logical_rules(make_ruleset(("data", "model"))):
        assert shard_hint(x, ("batch", "embed")) is x
