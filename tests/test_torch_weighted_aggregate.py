"""The port's weighted_aggregate against the reference.

On the CPU the op runs its plain version, held here against the JAX
package's oracle and its Pallas kernel in interpret mode on the same
numpy inputs. The CUDA kernel itself runs only on a card:
``chip_smoke.py`` holds it against the plain version there.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.weighted_aggregate.ops import (  # noqa: E402
    aggregate_pytree as jax_aggregate_pytree,
    weighted_aggregate as jax_weighted_aggregate)
from repro.kernels.weighted_aggregate.ref import (  # noqa: E402
    weighted_aggregate_ref as jax_ref)
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.weighted_aggregate import (  # noqa: E402
    TABLE, THREADS, aggregate_pytree, plan_launches, weighted_aggregate,
    weighted_aggregate_ref)
from repro_torch.models import build_model  # noqa: E402
from repro_torch.utils import tree_leaves, tree_map  # noqa: E402

# f32: the sums of C products may be taken in another order;
# bf16: one bf16 ulp at the final cast
TOL = {"float32": 1e-6, "bfloat16": 8e-3}


def _inputs(C, M, dtype, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((C, M)).astype(np.float32)
    w = rng.uniform(size=(C,)).astype(np.float32)
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    xj = jnp.asarray(x).astype(getattr(jnp, dtype))
    return xt, torch.from_numpy(w), xj, jnp.asarray(w)


def _f32(a):
    return np.asarray(jnp.asarray(a, jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("M", [1, 511, 4096])
@pytest.mark.parametrize("C", [1, 3, 16, 20])
def test_plain_matches_reference(C, M, dtype):
    xt, wt, xj, wj = _inputs(C, M, dtype, seed=C * 7919 + M)
    out = weighted_aggregate(xt, wt)
    assert out.dtype == xt.dtype and out.shape == (M,)
    got = out.float().numpy()
    tol = TOL[dtype]
    np.testing.assert_allclose(got, _f32(jax_ref(xj, wj)), rtol=tol,
                               atol=tol)
    pallas = jax_weighted_aggregate(xj, wj, impl="pallas", interpret=True)
    np.testing.assert_allclose(got, _f32(pallas), rtol=tol, atol=tol)


def test_aggregate_pytree_matches_reference():
    rng = np.random.default_rng(1)
    tree = {"conv0": {"w": rng.standard_normal((5, 3, 3, 2, 4)),
                      "b": rng.standard_normal((5, 4))},
            "fc": {"w": rng.standard_normal((5, 7, 3))}}
    tree = {k: {n: a.astype(np.float32) for n, a in v.items()}
            for k, v in tree.items()}
    w = rng.uniform(size=(5,)).astype(np.float32)
    got = aggregate_pytree(
        {k: {n: torch.from_numpy(a) for n, a in v.items()}
         for k, v in tree.items()}, torch.from_numpy(w))
    want = jax_aggregate_pytree(
        {k: {n: jnp.asarray(a) for n, a in v.items()}
         for k, v in tree.items()}, jnp.asarray(w), impl="naive")
    for k in tree:
        for n in tree[k]:
            assert got[k][n].shape == tree[k][n].shape[1:]
            np.testing.assert_allclose(got[k][n].numpy(),
                                       np.asarray(want[k][n]),
                                       rtol=1e-6, atol=1e-6)


def test_fedtest_cnn_tree_matches_reference():
    """The round's own tree: fedtest-cnn's ten leaves stacked over C=20
    clients, through the CPU route and the JAX package's tree op (its
    plain oracle and its Pallas kernel in interpret mode)."""
    rng = np.random.default_rng(3)
    shapes = build_model(get_config("fedtest-cnn")).param_shapes()
    stacked = tree_map(lambda s: rng.standard_normal((20,) + tuple(s))
                       .astype(np.float32), shapes)
    w = rng.uniform(size=(20,)).astype(np.float32)
    got = aggregate_pytree(tree_map(torch.from_numpy, stacked),
                           torch.from_numpy(w))
    assert len(tree_leaves(got)) == 10
    for impl in ("naive", "pallas"):
        want = jax_aggregate_pytree(tree_map(jnp.asarray, stacked),
                                    jnp.asarray(w), impl=impl,
                                    interpret=True)
        for g, j, x in zip(tree_leaves(got), tree_leaves(want),
                           tree_leaves(stacked)):
            assert g.shape == x.shape[1:]
            np.testing.assert_allclose(g.numpy(), np.asarray(j),
                                       rtol=1e-5, atol=1e-5,
                                       err_msg=impl)


@pytest.mark.parametrize("n_leaves", [1, 10, 64, 65, 200])
def test_plan_covers_every_chunk_once(n_leaves):
    """The grouped kernel's planner: one launch a table of TABLE leaves,
    every leaf in exactly one launch, in order; each leaf's blocks cover
    its vector chunks (VEC columns where its width and alignment allow
    16-byte loads, else one column) exactly once, with the slack of one
    partial block at most."""
    rng = np.random.default_rng(n_leaves)
    sizes = [int(m) for m in rng.integers(1, 5000, size=n_leaves)]
    fixed = [4, 10, 1 << 16]      # a vector leaf, a ragged one, a wide one
    sizes[:len(fixed)] = fixed[:n_leaves]
    aligned = [bool(a) for a in rng.integers(0, 2, size=n_leaves)]
    plan = plan_launches(sizes, aligned, 4)
    assert len(plan) == -(-n_leaves // TABLE)
    assert [i for launch in plan for i in launch.leaves] == list(
        range(n_leaves))
    for launch in plan:
        assert 1 <= len(launch.leaves) <= TABLE
        assert launch.first_block[0] == 0
        assert len(launch.first_block) == len(launch.leaves) + 1
        for j, (i, unit) in enumerate(zip(launch.leaves, launch.units)):
            assert unit == (4 if aligned[i] and sizes[i] % 4 == 0 else 1)
            blocks = range(launch.first_block[j], launch.first_block[j + 1])
            chunks = [(b - blocks.start) * THREADS + t for b in blocks
                      for t in range(THREADS)]
            live = [c for c in chunks if c * unit < sizes[i]]
            assert live == list(range(-(-sizes[i] // unit)))
            assert len(chunks) - len(live) < THREADS


def test_onehot_weight_selects_client_exactly():
    rng = np.random.default_rng(2)
    tree = {"a": torch.from_numpy(rng.standard_normal((4, 3, 5))
                                  .astype(np.float32)),
            "b": torch.from_numpy(rng.standard_normal((4, 7))
                                  .astype(np.float32))}
    agg = aggregate_pytree(tree, torch.tensor([0.0, 1.0, 0.0, 0.0]))
    assert torch.equal(agg["a"], tree["a"][1])
    assert torch.equal(agg["b"], tree["b"][1])


def test_cpu_input_runs_plain_version_without_counting():
    xt, wt, _, _ = _inputs(3, 10, "float32")
    before = weighted_aggregate.launches
    assert torch.equal(weighted_aggregate(xt, wt),
                       weighted_aggregate_ref(xt, wt))
    assert weighted_aggregate.launches == before


@pytest.mark.parametrize("x_shape,w_shape,dtype,w_dtype,err", [
    ((3, 8), (4,), torch.float32, torch.float32, ValueError),
    ((24,), (3,), torch.float32, torch.float32, ValueError),
    ((3, 8), (3,), torch.float16, torch.float32, TypeError),
    ((3, 8), (3,), torch.float32, torch.bfloat16, TypeError),
])
def test_wrapper_refuses_bad_inputs(x_shape, w_shape, dtype, w_dtype, err):
    with pytest.raises(err):
        weighted_aggregate(torch.zeros(x_shape, dtype=dtype),
                           torch.zeros(w_shape, dtype=w_dtype))


def test_non_cpu_non_cuda_tensor_raises_instead_of_falling_back():
    x = torch.empty((3, 8), device="meta")
    w = torch.empty((3,), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        weighted_aggregate(x, w)


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build._nvcc()


def test_library_name_tracks_the_source():
    path = build.library_path("weighted_aggregate")
    assert path.parent == build.BUILD_DIR
    assert path.name.startswith("libweighted_aggregate-")
    assert path == build.library_path("weighted_aggregate")
