"""The port's vlm family (``pixtral-12b``) against the reference.

At ``reduce_for_smoke`` size in f32 (2 layers, d_model 256, 4 heads of
32 over 4 KV heads, 16 patches, vocab 512): params made by the JAX
package go through ``params_from_reference`` (``patch_proj`` among
them), the same numpy tokens and patches go through both models (the
reference with ``attn_impl="naive"``, the port on the CPU, where its
attention ops run their plain versions). Tolerance rtol=1e-4,
atol=1e-5: XLA and PyTorch sum the projections in other orders; the
port's teacher-forced decode against its own full forward at 3e-4, as
``tests/test_decode_consistency.py`` holds the reference's. The logits
cover the patches and the text, so teacher forcing reads position
``num_patches + S``.

Torch runs on one thread here: these small ops lose far more to thread
hand-offs than they gain when the suite's other workers share the cores.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.config import reduce_for_smoke as jreduce  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import build_model as jbuild_model  # noqa: E402
from repro_torch.config import reduce_for_smoke  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_reference  # noqa: E402
from repro_torch.launch import serve as serve_mod  # noqa: E402
from repro_torch.models import attention as attn_mod  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.frontend_stub import (  # noqa: E402
    stub_embeddings, stub_shape)
from repro_torch.utils import tree_leaves  # noqa: E402

ARCH = "pixtral-12b"
RTOL, ATOL = 1e-4, 1e-5
TF_TOL = 3e-4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@functools.lru_cache(maxsize=None)
def _jmodel():
    cfg = jreduce(jget_config(ARCH)).replace(dtype="float32")
    model = jbuild_model(cfg, attn_impl="naive")
    return model, jax.jit(model.init)


def _pair(seed=0):
    jmodel, jinit = _jmodel()
    jparams = jinit(jax.random.PRNGKey(seed))
    cfg = reduce_for_smoke(get_config(ARCH)).replace(dtype="float32")
    tmodel = build_model(cfg)
    tparams = params_from_reference(_np(jparams), "cpu", model=tmodel)
    return jmodel, tmodel, jparams, tparams


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _batch(cfg, B, S, seed=1):
    """numpy tokens [B,S] and stub patches [B, num_patches, D] (N(0, 1) x
    0.02, as ``stub_embeddings`` draws them), for both packages."""
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab_size,
                                   size=(B, S)).astype(np.int32),
            "patches": (rng.standard_normal((B, cfg.num_patches,
                                             cfg.d_model))
                        * 0.02).astype(np.float32)}


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _assert_tree_close(got, want, **tol):
    flat_want = jax.tree_util.tree_leaves(want)
    flat_got = tree_leaves(got)
    assert len(flat_got) == len(flat_want)
    for g, w in zip(flat_got, flat_want):
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(w, np.float32), **tol)


def test_config_matches_reference_field_for_field():
    for port, ref in ((get_config(ARCH), jget_config(ARCH)),
                      (reduce_for_smoke(get_config(ARCH)),
                       jreduce(jget_config(ARCH)))):
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert get_config(ARCH).param_count() == 12_273_996_800 == \
        jget_config(ARCH).param_count()
    assert (reduce_for_smoke(get_config(ARCH)).param_count()
            == jreduce(jget_config(ARCH)).param_count())


def test_param_tree_has_patch_proj_as_reference():
    _, tmodel, jparams, tparams = _pair()
    D = tmodel.cfg.d_model
    assert tuple(tparams["patch_proj"].shape) == (D, D)
    assert (jax.tree_util.tree_map(lambda a: tuple(a.shape), _np(jparams))
            == _shapes(tmodel.param_shapes()))
    _assert_tree_close(tparams, _np(jparams), rtol=0, atol=0)


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    return tuple(tree)


def test_stub_embeddings_shape_dtype_and_stream():
    cfg = reduce_for_smoke(get_config(ARCH))
    a = stub_embeddings(cfg, 3, torch.Generator().manual_seed(0),
                        torch.bfloat16)
    b = stub_embeddings(cfg, 3, torch.Generator().manual_seed(0),
                        torch.bfloat16)
    assert tuple(a.shape) == stub_shape(cfg, 3) == (3, cfg.num_patches,
                                                     cfg.d_model)
    assert a.dtype == torch.bfloat16 and torch.equal(a, b)
    assert 0.01 < float(a.float().std()) < 0.03
    with pytest.raises(ValueError, match="no frontend stub"):
        stub_shape(get_config("qwen2-0.5b"), 1)


def test_prefill_logits_and_caches_match_reference():
    jmodel, tmodel, jparams, tparams = _pair(seed=3)
    cfg = tmodel.cfg
    batch = _batch(cfg, 2, 10, seed=4)
    cap = cfg.num_patches + 14
    jlogits, jcache = jax.jit(lambda p, b: jmodel.prefill(p, b,
                                                          cache_len=cap))(
        jparams, _j(batch))
    tlogits, tcache = tmodel.prefill(tparams, _t(batch), cache_len=cap)
    assert tlogits.shape == (2, cfg.num_patches + 10, cfg.vocab_size)
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits),
                               rtol=RTOL, atol=ATOL)
    assert tcache["layers"]["slot_0"]["k"].shape == (
        cfg.num_layers, 2, cap, cfg.num_kv_heads, cfg.head_dim)
    assert tcache["length"].tolist() == [cfg.num_patches + 10] * 2
    _assert_tree_close(tcache, _np(jcache), rtol=RTOL, atol=ATOL)


def test_two_decode_steps_match_reference():
    jmodel, tmodel, jparams, tparams = _pair(seed=5)
    cfg = tmodel.cfg
    batch = _batch(cfg, 3, 10, seed=6)
    head = {"tokens": batch["tokens"][:, :8], "patches": batch["patches"]}
    cap = cfg.num_patches + 12
    _, jcache = jax.jit(lambda p, b: jmodel.prefill(p, b, cache_len=cap))(
        jparams, _j(head))
    _, tcache = tmodel.prefill(tparams, _t(head), cache_len=cap)
    jdecode = jax.jit(jmodel.decode_step)
    for i in (8, 9):
        tok = batch["tokens"][:, i:i + 1]
        jlogits, jcache = jdecode(jparams, jcache, jnp.asarray(tok))
        tlogits, tcache = tmodel.decode_step(tparams, tcache,
                                             torch.from_numpy(tok))
        np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits),
                                   rtol=RTOL, atol=ATOL)
        _assert_tree_close(tcache, _np(jcache), rtol=RTOL, atol=ATOL)
    assert tcache["length"].tolist() == [cfg.num_patches + 10] * 3


def test_forward_train_and_loss_pad_labels_over_the_patches():
    jmodel, tmodel, jparams, tparams = _pair(seed=7)
    cfg = tmodel.cfg
    batch = _batch(cfg, 2, 12, seed=8)
    rng = np.random.default_rng(9)
    batch["labels"] = rng.integers(0, cfg.vocab_size,
                                   (2, 12)).astype(np.int32)
    jlogits, _ = jax.jit(jmodel.forward_train)(jparams, _j(batch))
    got = tmodel.forward_train(tparams, _t(batch))
    assert got.shape == (2, cfg.num_patches + 12, cfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(jlogits), rtol=RTOL,
                               atol=ATOL)
    jloss, jmetrics = jax.jit(jmodel.loss)(jparams, _j(batch))
    tloss, tmetrics = tmodel.loss(tparams, _t(batch))
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=RTOL,
                               atol=ATOL)
    for k in ("nll", "accuracy", "moe_aux"):
        np.testing.assert_allclose(float(tmetrics[k]), float(jmetrics[k]),
                                   rtol=RTOL, atol=ATOL)
    # the text labels padded with -1 over the patches: the same loss as
    # labels given at full length
    padded = dict(batch, labels=np.concatenate(
        [np.full((2, cfg.num_patches), -1, np.int32), batch["labels"]], 1))
    tpadded, _ = tmodel.loss(tparams, _t(padded))
    assert float(tpadded) == float(tloss)


def test_decode_matches_teacher_forced():
    """The port's own consistency: prefill over patches and text, then two
    decode steps give the logits of a full forward at ``num_patches + S``
    and one after."""
    _, tmodel, _, tparams = _pair(seed=10)
    off = tmodel.cfg.num_patches
    B, S = 2, 16
    batch = _t(_batch(tmodel.cfg, B, S + 2, seed=11))
    full = tmodel.forward_train(tparams, batch)
    toks = batch["tokens"]
    _, cache = tmodel.prefill(tparams, {"tokens": toks[:, :S],
                                        "patches": batch["patches"]},
                              cache_len=off + S + 4)
    lg1, cache = tmodel.decode_step(tparams, cache, toks[:, S:S + 1])
    lg2, cache = tmodel.decode_step(tparams, cache, toks[:, S + 1:S + 2])
    assert float((full[:, off + S] - lg1[:, 0]).abs().max()) < TF_TOL
    assert float((full[:, off + S + 1] - lg2[:, 0]).abs().max()) < TF_TOL
    assert cache["length"].tolist() == [off + S + 2] * B


def test_serve_cli_runs_on_cpu_and_needs_a_card(monkeypatch):
    calls = []
    real_rope = attn_mod.rope
    monkeypatch.setattr(attn_mod, "rope",
                        lambda *a, **kw: calls.append(1) or real_rope(*a,
                                                                      **kw))
    res = serve_mod.main(["--device", "cpu", "--smoke", "--arch", ARCH,
                          "--batch", "2", "--prompt-len", "8", "--gen", "3"])
    P = reduce_for_smoke(get_config(ARCH)).num_patches
    assert res["tokens"].shape == (2, 3)
    assert res["cache"]["length"].tolist() == [P + 10] * 2
    # the capacity counts the patches, as the reference's server sizes it
    assert res["cache"]["layers"]["slot_0"]["k"].shape[2] == P + 8 + 3 + 1
    assert calls            # pixtral's attention is roped, whisper's not
    _, _, batch, _ = serve_mod.build(serve_mod.parse_args(
        ["--device", "cpu", "--smoke", "--arch", ARCH, "--batch", "2"]))
    assert tuple(batch["patches"].shape) == (2, P, 256)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        serve_mod.build(serve_mod.parse_args(["--smoke", "--arch", ARCH]))
