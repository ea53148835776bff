"""The dry-run's stand-ins, the chunked loss, remat and the perf variants
of the port against the reference, on the CPU.

* ``input_specs``, ``cache_specs`` and ``params_and_opt_specs``: the
  names, shapes and dtypes of the port's fake tensors equal the
  reference's ``eval_shape`` for every arch x shape, at the full configs
  (the reference's traces of all 40 combinations take seconds);
* ``Model.ce_chunk`` (``_chunked_ce``) equals the reference's chunked
  loss and the port's unchunked loss, at rtol 1e-4 / atol 1e-5, on a
  2-layer qwen2 in f32 from the reference's init;
* ``loss(..., remat=True)``'s grads are bitwise those without it (one
  layer a checkpoint), for a decoder stack and an encdec one;
* the seven perf variants whose knob the port has not raise, and the
  rest are the reference's.
"""
import ast
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.config import INPUT_SHAPES as J_SHAPES  # noqa: E402
from repro.config import reduce_for_smoke as jreduce  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import list_configs  # noqa: E402
from repro.launch import specs as jspecs  # noqa: E402
from repro.models import build_model as jbuild_model  # noqa: E402
from repro_torch.config import INPUT_SHAPES, reduce_for_smoke  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_reference  # noqa: E402
from repro_torch.launch import perf, specs  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.utils import tree_leaves  # noqa: E402

ARCHS = [a for a in list_configs() if not a.startswith("fedtest-")]
RTOL, ATOL = 1e-4, 1e-5


def _flat(tree, path=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, path + (k,)))
        return out
    return {path: (tuple(tree.shape), str(tree.dtype).split(".")[-1])}


def _flat_ref(tree):
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {tuple(k.key for k in path): (tuple(leaf.shape), str(leaf.dtype))
            for path, leaf in leaves}


@pytest.mark.parametrize("arch", ARCHS)
def test_stand_ins_equal_the_references_eval_shape(arch):
    cfg, jcfg = get_config(arch), jget_config(arch)
    for name, shape in INPUT_SHAPES.items():
        jshape = J_SHAPES[name]
        assert specs.supported(cfg, shape) == jspecs.supported(jcfg, jshape)
        if not specs.supported(cfg, shape)[0]:
            continue
        assert _flat(specs.input_specs(cfg, shape)) == \
            _flat_ref(jspecs.input_specs(jcfg, jshape))
        params, opt = specs.params_and_opt_specs(cfg, shape)
        jparams, jopt = jspecs.params_and_opt_specs(jcfg, jshape)
        assert _flat(params) == _flat_ref(jparams)
        assert (opt is None) == (jopt is None)
        if opt is not None:
            assert _flat(opt) == _flat_ref(jopt)
        if shape.kind == "decode":
            assert _flat(specs.cache_specs(cfg, shape)) == \
                _flat_ref(jspecs.cache_specs(jcfg, jshape))
        model, jmodel = specs.model_for(cfg, shape), jspecs.model_for(jcfg,
                                                                      jshape)
        assert model.sliding_window == jmodel.sliding_window
        assert model.max_target_positions == jmodel.max_target_positions


def _lm_batch(cfg, B=2, S=32, seed=0):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    labels[0, :5] = -1                   # some ignored rows
    return tokens, labels


def test_chunked_loss_equals_the_reference_and_the_unchunked():
    jcfg = jreduce(jget_config("qwen2-0.5b")).replace(dtype="float32")
    cfg = reduce_for_smoke(get_config("qwen2-0.5b")).replace(dtype="float32")
    jmodel = jbuild_model(jcfg, ce_chunk=8)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tokens, labels = _lm_batch(cfg)
    jloss, jm = jax.jit(jmodel.loss)(jparams, {
        "tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)})
    params = params_from_reference(
        jax.tree_util.tree_map(np.asarray, jparams), "cpu",
        model=build_model(cfg))
    batch = {"tokens": torch.as_tensor(tokens),
             "labels": torch.as_tensor(labels)}
    loss, m = build_model(cfg, ce_chunk=8).loss(params, batch)
    whole, wm = build_model(cfg).loss(params, batch)
    for got in ((loss, m), (whole, wm)):
        np.testing.assert_allclose(got[0].detach().numpy(), np.asarray(jloss),
                                   rtol=RTOL, atol=ATOL)
        for k in ("nll", "accuracy"):
            np.testing.assert_allclose(got[1][k].detach().numpy(),
                                       np.asarray(jm[k]), rtol=RTOL,
                                       atol=ATOL)


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "whisper-base"])
def test_remat_grads_are_bitwise_the_plain_grads(arch):
    cfg = reduce_for_smoke(get_config(arch)).replace(dtype="float32")
    tokens, labels = _lm_batch(cfg, S=16)
    batch = {"tokens": torch.as_tensor(tokens),
             "labels": torch.as_tensor(labels)}
    if cfg.family == "encdec":
        rng = np.random.default_rng(1)
        batch["frames"] = torch.as_tensor(rng.standard_normal(
            (2, cfg.encoder_seq, cfg.d_model)).astype(np.float32))
    model = build_model(cfg, differentiable=True)
    params = model.init(torch.Generator().manual_seed(0))
    grads = []
    for remat in (False, True):
        leaves = [t.detach().requires_grad_() for t in tree_leaves(params)]
        it = iter(leaves)
        tree = jax.tree_util.tree_map(lambda _: next(it), params)
        loss, _ = model.loss(tree, batch, remat=remat)
        grads.append(torch.autograd.grad(loss, leaves))
    for a, b in zip(*grads):
        assert torch.equal(a, b)


def _reference_variants():
    path = os.path.join(os.path.dirname(__file__), "..", "src", "repro",
                        "launch", "perf.py")
    with open(path) as fh:
        tree = ast.parse(fh.read())
    for node in tree.body:
        if (isinstance(node, ast.Assign)
                and getattr(node.targets[0], "id", "") == "VARIANTS"):
            return {k.value for k in node.value.keys}
    raise AssertionError("no VARIANTS in the reference's perf.py")


def test_variants_are_the_references():
    assert set(perf.VARIANTS) | set(perf.NOT_PORTED) == _reference_variants()
    assert not set(perf.VARIANTS) & set(perf.NOT_PORTED)
    assert len(perf.NOT_PORTED) == 7


@pytest.mark.parametrize("name", sorted(perf.NOT_PORTED))
def test_variants_not_ported_raise(name):
    with pytest.raises(ValueError, match="not ported"):
        perf.run_variant("qwen2-72b", "decode_32k", name)
