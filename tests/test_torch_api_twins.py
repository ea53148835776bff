"""The reference's last public names in the port, held against the
reference on the same numpy inputs (CPU):

* the pytree helpers ``repro_torch.utils`` exports (``tree_size``,
  ``tree_bytes``, ``tree_zeros_like``, ``tree_add``, ``tree_scale``,
  ``tree_weighted_sum`` on a list and on a stacked tree,
  ``tree_l2_norm``, ``tree_cast``) to rtol 1e-6;
* ``repro_torch.core.apply_attacks``: ``sign_flip``, ``scaled_update``
  and ``none`` exactly, ``random_weights`` on the reference's own
  normals (rebuilt with ``key_iter`` and a split a leaf, as the
  reference draws them) to rtol 1e-6;
* ``CheckpointManager.maybe_save`` and ``.restore``: the cadence, and a
  torn newest file skipped, as ``tests/test_checkpoint.py`` holds the
  reference's;
* ``MeshConfig`` and its ``num_devices``.
"""
import glob

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.utils as jutils  # noqa: E402
from repro.checkpoint import CheckpointManager as JCheckpointManager  # noqa: E402
from repro.config import MeshConfig as JMeshConfig  # noqa: E402
from repro.core.attacks import apply_attacks as japply_attacks  # noqa: E402
import repro_torch.utils as utils  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.config import MeshConfig  # noqa: E402
from repro_torch.core import apply_attacks  # noqa: E402

RTOL = 1e-6


def _tree(rng, lead=()):
    """A nested tree of f32 leaves and one int leaf, ``lead`` axes in
    front, as numpy."""
    return {"conv": {"w": rng.standard_normal(lead + (3, 3, 2)).astype(
        np.float32), "b": rng.standard_normal(lead + (2,)).astype(
        np.float32)},
        "dense": {"w": rng.standard_normal(lead + (5, 4)).astype(
            np.float32)},
        "step": np.arange(int(np.prod(lead + (3,))),
                          dtype=np.int32).reshape(lead + (3,))}


def _j(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _t(tree):
    return utils.tree_map(torch.from_numpy, tree)


def _close(got, want, rtol=RTOL, exact=False):
    got_leaves = utils.tree_leaves(got)
    want_leaves = jax.tree_util.tree_leaves(want)
    assert len(got_leaves) == len(want_leaves)
    for g, w in zip(got_leaves, want_leaves):
        w = np.asarray(w)
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        assert g.shape == w.shape and g.dtype == w.dtype, (g.dtype, w.dtype)
        if exact:
            assert g.tobytes() == w.tobytes()
        else:
            np.testing.assert_allclose(g, w, rtol=rtol, atol=1e-7)


# ------------------------------------------------------------ pytree helpers
@pytest.mark.parametrize("name", ["tree_size", "tree_bytes", "tree_l2_norm"])
def test_tree_reductions_match_the_reference(name):
    tree = _tree(np.random.default_rng(0))
    got, want = getattr(utils, name)(_t(tree)), getattr(jutils, name)(
        _j(tree))
    np.testing.assert_allclose(float(got), float(want), rtol=RTOL)


@pytest.mark.parametrize("name,args", [
    ("tree_zeros_like", ()), ("tree_scale", (0.37,)),
    ("tree_cast", ("bfloat16",)), ("tree_cast", ("float16",))])
def test_tree_maps_match_the_reference(name, args):
    tree = _tree(np.random.default_rng(1))
    targs = [getattr(torch, a) if isinstance(a, str) else a for a in args]
    jargs = [getattr(jnp, a) if isinstance(a, str) else a for a in args]
    got = getattr(utils, name)(_t(tree), *targs)
    want = getattr(jutils, name)(_j(tree), *jargs)
    if name == "tree_cast":
        # numpy has no bf16: compare each leaf's dtype, then in f32
        for g, w in zip(utils.tree_leaves(got),
                        jax.tree_util.tree_leaves(want)):
            assert str(g.dtype).split(".")[-1] == str(w.dtype)
        got = utils.tree_map(lambda x: x.float() if x.is_floating_point()
                             else x, got)
        want = jax.tree_util.tree_map(
            lambda x: x.astype(jnp.float32)
            if jnp.issubdtype(x.dtype, jnp.floating) else x, want)
    _close(got, want)


def test_tree_add_matches_the_reference():
    rng = np.random.default_rng(2)
    a, b = _tree(rng), _tree(rng)
    _close(utils.tree_add(_t(a), _t(b)), jutils.tree_add(_j(a), _j(b)))


@pytest.mark.parametrize("form", ["list", "stacked"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tree_weighted_sum_matches_the_reference(form, dtype):
    rng = np.random.default_rng(3)
    trees = [{k: v for k, v in _tree(rng).items() if k != "step"}
             for _ in range(4)]
    w = rng.dirichlet(np.ones(4)).astype(np.float32)
    tt = [utils.tree_cast(_t(t), getattr(torch, dtype)) for t in trees]
    jt = [jutils.tree_cast(_j(t), getattr(jnp, dtype)) for t in trees]
    if form == "stacked":
        tt = utils.tree_map(lambda *xs: torch.stack(xs), *tt)
        jt = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *jt)
    got = utils.tree_weighted_sum(tt, torch.from_numpy(w))
    want = jutils.tree_weighted_sum(jt, jnp.asarray(w))
    for g in utils.tree_leaves(got):
        assert g.dtype == getattr(torch, dtype)
    got = utils.tree_map(lambda x: x.float(), got)
    want = jax.tree_util.tree_map(lambda x: x.astype(jnp.float32), want)
    # f32 accumulation in both; a bf16 result is one rounding of it
    _close(got, want, rtol=RTOL if dtype == "float32" else 1e-2)


# ------------------------------------------------------------ apply_attacks
def _stack(seed, n=5):
    rng = np.random.default_rng(seed)
    stack = {k: v for k, v in _tree(rng, (n,)).items() if k != "step"}
    glob_ = {k: v for k, v in _tree(rng).items() if k != "step"}
    return stack, glob_


@pytest.mark.parametrize("attack,scale", [
    ("sign_flip", 1.0), ("sign_flip", 3.0), ("scaled_update", 10.0),
    ("none", 1.0)])
@pytest.mark.parametrize("num_malicious", [0, 2])
def test_apply_attacks_matches_the_reference(attack, scale, num_malicious):
    stack, glob_ = _stack(4)
    got = apply_attacks(None, _t(stack), _t(glob_),
                        num_malicious=num_malicious, attack=attack,
                        scale=scale)
    want = japply_attacks(jax.random.PRNGKey(0), _j(stack), _j(glob_),
                          num_malicious=num_malicious, attack=attack,
                          scale=scale)
    _close(got, want, exact=True)


def _leaf_normals(client_key, leaves):
    """One attacked client's normals as the reference's
    ``_random_weights`` draws them: ``split(key, n_leaves)``, one a
    leaf."""
    ks = jax.random.split(client_key, len(leaves))
    return [torch.from_numpy(np.array(jax.random.normal(
        k, leaf.shape, jnp.float32))) for k, leaf in zip(ks, leaves)]


def test_random_weights_on_the_references_normals():
    """The reference draws client i's noise (i-th of the attacked) from
    the i-th key of ``key_iter(key)``, split into one key a leaf: those
    normals, given to the port, give the reference's models."""
    stack, glob_ = _stack(5)
    key, m = jax.random.PRNGKey(7), 3
    leaves = jax.tree_util.tree_leaves(_j(glob_))
    keys = jutils.key_iter(key)
    noise = [_leaf_normals(next(keys), leaves) for _ in range(m)]
    got = apply_attacks(noise, _t(stack), _t(glob_), num_malicious=m,
                        attack="random_weights", scale=2.0)
    want = japply_attacks(key, _j(stack), _j(glob_), num_malicious=m,
                          attack="random_weights", scale=2.0)
    _close(got, want)
    # the honest clients' models are the stack's, bitwise
    for g, s in zip(utils.tree_leaves(got), utils.tree_leaves(stack)):
        assert g[:-m].numpy().tobytes() == s[:-m].tobytes()
    with pytest.raises(ValueError, match="noise"):
        apply_attacks(None, _t(stack), _t(glob_), num_malicious=1)


# --------------------------------------------------------- checkpoint twins
def test_maybe_save_keeps_the_references_cadence(tmp_path):
    tree = {"w": np.zeros(2, np.float32)}
    got = CheckpointManager(str(tmp_path / "port"), save_every=3)
    want = JCheckpointManager(str(tmp_path / "ref"), save_every=3)
    saved = [s for s in range(10) if got.maybe_save(s, tree)]
    assert saved == [s for s in range(10)
                     if want.maybe_save(s, _j(tree))] == [3, 6, 9]
    assert got.steps() == want.steps() == [3, 6, 9]
    off = CheckpointManager(str(tmp_path / "off"), save_every=0)
    assert off.maybe_save(3, tree) is None
    assert JCheckpointManager(str(tmp_path / "joff"),
                              save_every=0).maybe_save(3, tree) is None
    assert off.steps() == []
    # a manifest goes with the first save the cadence asks for
    man = CheckpointManager(str(tmp_path / "man"), save_every=2)
    assert man.maybe_save(1, tree, manifest={"run": 1}) is None
    assert man.read_manifest() is None
    assert man.maybe_save(2, tree, manifest={"run": 1}).endswith(
        "ckpt_00000002.npz")
    assert man.read_manifest() == {"run": 1}


def test_restore_skips_a_torn_checkpoint_as_the_reference(tmp_path):
    """A torn newest checkpoint costs one cadence interval: ``restore``
    warns and returns the step before it, in both packages; with every
    file torn both raise ``FileNotFoundError``."""
    tree = {"w": np.zeros(3, np.float32)}
    mgrs = {"port": CheckpointManager(str(tmp_path / "port"), keep=3),
            "ref": JCheckpointManager(str(tmp_path / "ref"), keep=3)}
    out = {}
    for name, mgr in mgrs.items():
        for step in (1, 2):
            mgr.save(step, {"w": tree["w"] + step})
        (tmp_path / name / "ckpt_00000003.npz").write_bytes(
            b"torn write garbage")
        with pytest.warns(RuntimeWarning, match="skipping corrupt"):
            out[name] = mgr.restore(tree if name == "port" else _j(tree))
        assert np.asarray(mgr.restore(
            tree if name == "port" else _j(tree), step=1)["w"]).tolist() \
            == [1.0] * 3
        for f in glob.glob(str(tmp_path / name / "ckpt_*.npz")):
            with open(f, "wb") as fh:
                fh.write(b"x")
        with pytest.warns(RuntimeWarning):
            with pytest.raises(FileNotFoundError, match="no restorable"):
                mgr.restore(tree if name == "port" else _j(tree))
    np.testing.assert_array_equal(np.asarray(out["port"]["w"]),
                                  np.asarray(out["ref"]["w"]))
    assert np.asarray(out["port"]["w"]).tolist() == [2.0] * 3


# -------------------------------------------------------------- MeshConfig
@pytest.mark.parametrize("shape,axes", [
    ((16, 16), ("data", "model")), ((2, 32, 8), ("pod", "data", "model")),
    ((1,), ("data",))])
def test_mesh_config_matches_the_reference(shape, axes):
    got, want = MeshConfig(shape, axes), JMeshConfig(shape, axes)
    assert got.num_devices == want.num_devices
    assert (got.shape, got.axes) == (want.shape, want.axes)
    assert MeshConfig().num_devices == JMeshConfig().num_devices == 256
    with pytest.raises(ValueError, match="shape/axes"):
        MeshConfig((2, 2), ("data",))
    with pytest.raises(ValueError, match="shape/axes"):
        JMeshConfig((2, 2), ("data",))
