"""The port's classifiers and optimizers against the reference.

Params made by the JAX package go through ``params_from_reference``; the
same numpy images go through both forwards. Tolerance rtol=1e-4,
atol=1e-5: XLA's and oneDNN's convolutions sum in different orders.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.config import TrainConfig as JTrainConfig  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import build_model as jbuild_model  # noqa: E402
from repro.optim import make_optimizer as jmake_optimizer  # noqa: E402
from repro_torch.config import TrainConfig  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_reference  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.optim import make_optimizer  # noqa: E402
from repro_torch.utils import tree_leaves  # noqa: E402

RTOL, ATOL = 1e-4, 1e-5

# reduced widths; the mnist cnn hits the odd-size pool (28->14->7->4)
# and, like the cifar one, the NHWC flatten into fc1
ARCHS = {
    "fedtest-cnn": dict(cnn_channels=(8, 16, 16), cnn_hidden=32),
    "fedtest-cnn-mnist": dict(cnn_channels=(8, 16, 16), cnn_hidden=32),
    "fedtest-mlp-mnist": dict(mlp_hidden=(64, 32)),
}


@functools.lru_cache(maxsize=None)
def _jmodel_and_init(arch):
    jmodel = jbuild_model(jget_config(arch).replace(**ARCHS[arch]))
    return jmodel, jax.jit(jmodel.init)


def _pair(arch, seed=0):
    jmodel, jinit = _jmodel_and_init(arch)
    jcfg = jmodel.cfg
    tmodel = build_model(get_config(arch).replace(**ARCHS[arch]))
    jparams = jinit(jax.random.PRNGKey(seed))
    np_params = jax.tree_util.tree_map(np.asarray, jparams)
    tparams = params_from_reference(np_params, "cpu", model=tmodel)
    return jcfg, jmodel, tmodel, jparams, tparams


def _batch(cfg, B, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, cfg.image_size, cfg.image_size,
                             cfg.image_channels)).astype(np.float32)
    y = rng.integers(0, cfg.num_classes, size=B).astype(np.int32)
    return x, y


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_logits_match_reference(arch):
    jcfg, jmodel, tmodel, jparams, tparams = _pair(arch)
    x, _ = _batch(jcfg, 5)
    want = np.asarray(jax.jit(jmodel.forward_train)(
        jparams, {"images": jnp.asarray(x)})[0])
    got = tmodel.forward_train(tparams, {"images": torch.from_numpy(x)})
    assert got.shape == want.shape == (5, jcfg.num_classes)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_loss_and_param_count_match_reference(arch):
    jcfg, jmodel, tmodel, jparams, tparams = _pair(arch, seed=1)
    x, y = _batch(jcfg, 6, seed=1)
    jloss, jm = jax.jit(jmodel.loss)(jparams, {"images": jnp.asarray(x),
                                               "labels": jnp.asarray(y)})
    tloss, tm = tmodel.loss(tparams, {"images": torch.from_numpy(x),
                                      "labels": torch.from_numpy(y)})
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=RTOL,
                               atol=ATOL)
    assert float(tm["accuracy"]) == float(jm["accuracy"])
    assert tmodel.param_count() == tmodel.param_count(tparams) == \
        jmodel.param_count(jparams)


def test_full_width_cnn_has_the_paper_count():
    model = build_model(get_config("fedtest-cnn"))
    assert model.param_count() == 188_810
    leaves = [int(np.prod(s)) for s in tree_leaves(model.param_shapes())]
    # tree_leaves order: conv0.b, conv0.w, conv1.b, ... fc2.w
    assert leaves == [32, 864, 64, 18432, 64, 36864, 128, 131072, 10, 1280]


def test_port_init_has_the_reference_tree():
    tmodel = build_model(get_config("fedtest-cnn-mnist")
                         .replace(**ARCHS["fedtest-cnn-mnist"]))
    params = tmodel.init(torch.Generator().manual_seed(0))
    shapes = tmodel.param_shapes()
    assert sorted(params) == sorted(shapes)
    for name in shapes:
        for leaf in ("w", "b"):
            assert tuple(params[name][leaf].shape) == shapes[name][leaf]
            assert params[name][leaf].dtype == torch.float32
    # truncated normal at +-2 std, scaled by fan_in ** -0.5
    w = params["conv0"]["w"]
    assert float(w.abs().max()) <= 2.0 * (3 * 3 * 1) ** -0.5 + 1e-6


@pytest.mark.parametrize("mutate,match", [
    (lambda p: p.pop("fc2"), "missing leaves"),
    (lambda p: p["conv0"].pop("b"), "missing leaves"),
    (lambda p: p.update(extra={"w": np.zeros(3)}), "unexpected leaves"),
    (lambda p: p["fc1"].update(w=np.zeros((3, 4), np.float32)), "shape"),
])
def test_params_from_reference_refuses_a_wrong_tree(mutate, match):
    jcfg, jmodel, tmodel, jparams, _ = _pair("fedtest-cnn-mnist")
    np_params = jax.tree_util.tree_map(np.asarray, jparams)
    mutate(np_params)
    with pytest.raises(ValueError, match=match):
        params_from_reference(np_params, "cpu", model=tmodel)


@pytest.mark.parametrize("optimizer,schedule,clip", [
    ("sgd", "constant", 0.0),
    ("sgd", "cosine", 1.0),
    ("momentum", "linear_warmup_cosine", 0.5),
    ("adamw", "cosine", 1.0),
])
def test_k_steps_match_reference(optimizer, schedule, clip):
    """k=3 optimizer steps from the same params on the same batches."""
    jcfg, jmodel, tmodel, jparams, tparams = _pair("fedtest-cnn-mnist",
                                                   seed=2)
    kw = dict(optimizer=optimizer, lr=0.1 if "sgd" in optimizer
              or optimizer == "momentum" else 1e-3, schedule=schedule,
              warmup_steps=2, total_steps=5, grad_clip=clip, batch_size=8)
    jopt, topt = jmake_optimizer(JTrainConfig(**kw)), make_optimizer(
        TrainConfig(**kw))
    jstate, tstate = jopt.init(jparams), topt.init(tparams)

    @jax.jit
    def jstep(params, state, batch):
        grads = jax.grad(lambda p: jmodel.loss(p, batch)[0])(params)
        return jopt.update(grads, state, params)

    for k in range(3):
        x, y = _batch(jcfg, 8, seed=10 + k)
        jparams, jstate = jstep(jparams, jstate, {"images": jnp.asarray(x),
                                                  "labels": jnp.asarray(y)})
        tb = {"images": torch.from_numpy(x), "labels": torch.from_numpy(y)}
        tg, _ = torch.func.grad_and_value(tmodel.loss, has_aux=True)(
            tparams, tb)
        tparams, tstate = topt.update(tg, tstate, tparams)
    for jl, tl in zip(jax.tree_util.tree_leaves(jparams),
                      tree_leaves(tparams)):
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=RTOL,
                                   atol=ATOL)
    assert int(tstate["step"]) == int(jstate["step"]) == 3
