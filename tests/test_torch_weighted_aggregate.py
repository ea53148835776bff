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
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.weighted_aggregate import (  # noqa: E402
    aggregate_pytree, weighted_aggregate, weighted_aggregate_ref)

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
