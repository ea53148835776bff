"""The port's dense LM serve path against the reference.

``qwen2-0.5b`` (GQA group 7, QKV bias) and ``qwen3-1.7b`` (qk-norm, head
dim 128 at full width) at smoke size in f32: params made by the JAX
package go through ``params_from_reference``, the same numpy tokens go
through both models (the reference with ``attn_impl="naive"``, the port
on the CPU, where its attention ops run their plain versions).
Tolerance rtol=1e-4, atol=1e-5 on logits and caches: XLA and PyTorch sum
the projections in other orders. The teacher-forced checks use 3e-4, as
``tests/test_decode_consistency.py`` does.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.config import reduce_for_smoke as jreduce_for_smoke  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import build_model as jbuild_model  # noqa: E402
from repro.models.attention import (  # noqa: E402
    _cache_write_dus as jax_cache_write)
from repro_torch.config import ModelConfig, reduce_for_smoke  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_reference  # noqa: E402
from repro_torch.launch import serve as serve_mod  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.attention import _cache_write_dus  # noqa: E402
from repro_torch.utils import tree_leaves, tree_map  # noqa: E402

ARCHS = ("qwen2-0.5b", "qwen3-1.7b")
RTOL, ATOL = 1e-4, 1e-5
TF_TOL = 3e-4


@functools.lru_cache(maxsize=None)
def _jmodel(arch, dtype="float32"):
    cfg = jreduce_for_smoke(jget_config(arch)).replace(dtype=dtype)
    model = jbuild_model(cfg, attn_impl="naive")
    return model, jax.jit(model.init)


def _pair(arch, seed=0, **model_kw):
    jmodel, jinit = _jmodel(arch)
    jparams = jinit(jax.random.PRNGKey(seed))
    cfg = reduce_for_smoke(get_config(arch)).replace(dtype="float32")
    tmodel = build_model(cfg, **model_kw)
    tparams = params_from_reference(
        jax.tree_util.tree_map(np.asarray, jparams), "cpu", model=tmodel)
    return jmodel, tmodel, jparams, tparams


def _tokens(cfg, B, S, seed=1):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, size=(B, S)).astype(np.int32)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _assert_tree_close(got, want, **tol):
    flat_want = jax.tree_util.tree_leaves(want)
    flat_got = tree_leaves(got)
    assert len(flat_got) == len(flat_want)
    for g, w in zip(flat_got, flat_want):
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(w, np.float32), **tol)


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_reference_field_for_field(arch):
    for port, ref in ((get_config(arch), jget_config(arch)),
                      (reduce_for_smoke(get_config(arch)),
                       jreduce_for_smoke(jget_config(arch)))):
        for f in dataclasses.fields(ModelConfig):
            assert getattr(port, f.name) == getattr(ref, f.name), f.name
    assert (build_model(get_config(arch)).param_count()
            == jget_config(arch).param_count())


def test_qwen2_full_width_param_count():
    assert build_model(get_config("qwen2-0.5b")).param_count() == 494_032_768


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_prefill_match_reference(arch):
    jmodel, tmodel, jparams, tparams = _pair(arch)
    toks = _tokens(tmodel.cfg, 2, 12)
    want = np.asarray(jax.jit(jmodel.forward_train)(
        jparams, {"tokens": jnp.asarray(toks)})[0])
    got = tmodel.forward_train(tparams, {"tokens": torch.from_numpy(toks)})
    assert got.shape == want.shape == (2, 12, tmodel.cfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)

    jlogits, jcache = jax.jit(lambda p, b: jmodel.prefill(p, b, cache_len=16))(
        jparams, {"tokens": jnp.asarray(toks)})
    tlogits, tcache = tmodel.prefill(tparams,
                                     {"tokens": torch.from_numpy(toks)},
                                     cache_len=16)
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits),
                               rtol=RTOL, atol=ATOL)
    assert tcache["layers"]["slot_0"]["k"].shape == (
        tmodel.cfg.num_layers, 2, 16, tmodel.cfg.num_kv_heads,
        tmodel.cfg.head_dim)
    assert tcache["length"].dtype == torch.int32
    _assert_tree_close(tcache, _np(jcache), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_two_decode_steps_match_reference(arch):
    jmodel, tmodel, jparams, tparams = _pair(arch, seed=2)
    toks = _tokens(tmodel.cfg, 3, 10, seed=3)
    jprefill = jax.jit(lambda p, b: jmodel.prefill(p, b, cache_len=12))
    jdecode = jax.jit(jmodel.decode_step)
    _, jcache = jprefill(jparams, {"tokens": jnp.asarray(toks[:, :8])})
    _, tcache = tmodel.prefill(tparams,
                               {"tokens": torch.from_numpy(toks[:, :8])},
                               cache_len=12)
    for i in (8, 9):
        jlogits, jcache = jdecode(jparams, jcache, jnp.asarray(toks[:, i:i + 1]))
        tlogits, tcache = tmodel.decode_step(
            tparams, tcache, torch.from_numpy(toks[:, i:i + 1]))
        np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits),
                                   rtol=RTOL, atol=ATOL)
        _assert_tree_close(tcache, _np(jcache), rtol=RTOL, atol=ATOL)
    assert tcache["length"].tolist() == [10, 10, 10]


@pytest.mark.parametrize("arch,window", [("qwen2-0.5b", None),
                                         ("qwen3-1.7b", None),
                                         ("qwen2-0.5b", 8)])
def test_decode_matches_teacher_forced(arch, window):
    """The port's own consistency, as tests/test_decode_consistency.py
    holds the reference's: prefill + two decode steps give the logits of a
    full forward over the same tokens, with and without a window."""
    _, tmodel, _, tparams = _pair(arch, seed=4, sliding_window=window)
    B, S = 2, 24 if window else 16
    toks = torch.from_numpy(_tokens(tmodel.cfg, B, S + 2, seed=5))
    full = tmodel.forward_train(tparams, {"tokens": toks})
    _, cache = tmodel.prefill(tparams, {"tokens": toks[:, :S]},
                              cache_len=S + 4)
    lg1, cache = tmodel.decode_step(tparams, cache, toks[:, S:S + 1])
    lg2, cache = tmodel.decode_step(tparams, cache, toks[:, S + 1:S + 2])
    assert float((full[:, S] - lg1[:, 0]).abs().max()) < TF_TOL
    assert float((full[:, S + 1] - lg2[:, 0]).abs().max()) < TF_TOL
    assert cache["length"].tolist() == [S + 2] * B


def test_cache_write_clamps_at_capacity_as_dynamic_update_slice():
    rng = np.random.default_rng(6)
    cache = rng.standard_normal((4, 6, 2, 8)).astype(np.float32)
    new = rng.standard_normal((4, 1, 2, 8)).astype(np.float32)
    positions = np.asarray([0, 5, 6, 40], np.int32)   # 6 and 40 are >= T
    want = np.asarray(jax.jit(jax_cache_write)(
        jnp.asarray(cache), jnp.asarray(new), jnp.asarray(positions)))
    got = _cache_write_dus(torch.from_numpy(cache.copy()),
                           torch.from_numpy(new), torch.from_numpy(positions))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy()[2, 5], new[2, 0])


def test_decode_past_capacity_matches_reference():
    """A decode step on a full cache writes its row at T-1 in both
    packages and attends the whole cache."""
    jmodel, tmodel, jparams, tparams = _pair("qwen2-0.5b", seed=7)
    toks = _tokens(tmodel.cfg, 2, 9, seed=8)
    _, jcache = jax.jit(lambda p, b: jmodel.prefill(p, b, cache_len=8))(
        jparams, {"tokens": jnp.asarray(toks[:, :8])})
    _, tcache = tmodel.prefill(tparams,
                               {"tokens": torch.from_numpy(toks[:, :8])},
                               cache_len=8)
    jlogits, jcache = jax.jit(jmodel.decode_step)(
        jparams, jcache, jnp.asarray(toks[:, 8:9]))
    tlogits, tcache = tmodel.decode_step(tparams, tcache,
                                         torch.from_numpy(toks[:, 8:9]))
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits),
                               rtol=RTOL, atol=ATOL)
    _assert_tree_close(tcache, _np(jcache), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_serve_loop_matches_reference(arch):
    """The port's serve loop (``launch/serve.py``) against the reference's
    greedy loop on the same params and prompt: each token equal wherever
    the reference's top-two logit margin exceeds the tolerance; past the
    first near-tie the two continuations may differ."""
    jmodel, tmodel, jparams, tparams = _pair(arch, seed=9)
    B, S, gen_len = 3, 10, 8
    toks = _tokens(tmodel.cfg, B, S, seed=10)
    res = serve_mod.serve(tmodel, tparams,
                          {"tokens": torch.from_numpy(toks)}, gen_len, 0.0,
                          torch.Generator().manual_seed(0))
    got = res["tokens"].numpy()
    assert got.shape == (B, gen_len) and got.dtype == np.int32

    logits, cache = jax.jit(
        lambda p, b: jmodel.prefill(p, b, cache_len=S + gen_len + 1))(
            jparams, {"tokens": jnp.asarray(toks)})
    jdecode = jax.jit(jmodel.decode_step)
    live = np.ones(B, bool)          # rows not yet past a near-tie
    checked = 0
    for i in range(gen_len):
        last = np.asarray(logits[:, -1])
        top2 = np.sort(last, axis=-1)[:, -2:]
        want = last.argmax(-1)
        clear = (top2[:, 1] - top2[:, 0]) > 10 * ATOL
        rows = live & clear
        np.testing.assert_array_equal(got[rows, i], want[rows])
        checked += int(rows.sum())
        live &= clear
        if i + 1 < gen_len:
            # feed the reference the port's token so both stay on one path
            logits, cache = jdecode(jparams, cache,
                                    jnp.asarray(got[:, i:i + 1]))
    assert checked >= B * gen_len // 2, checked


def test_bf16_reference_tree_keeps_f32_norm_scales():
    jmodel, jinit = _jmodel("qwen3-1.7b", dtype="bfloat16")
    jparams = _np(jinit(jax.random.PRNGKey(11)))
    cfg = reduce_for_smoke(get_config("qwen3-1.7b"))
    tmodel = build_model(cfg)
    assert tmodel.dtype == torch.bfloat16
    tparams = params_from_reference(jparams, "cpu", model=tmodel)
    slot = tparams["layers"]["slot_0"]
    scales = [tparams["final_norm"]["scale"], slot["norm1"]["scale"],
              slot["norm2"]["scale"], slot["attn"]["q_norm"]["scale"],
              slot["attn"]["k_norm"]["scale"]]
    assert all(s.dtype == torch.float32 for s in scales)
    assert tparams["embed"].dtype == torch.bfloat16
    assert slot["attn"]["wq"].dtype == torch.bfloat16
    # every leaf is the reference's value exactly, in the reference's dtype
    want_dtypes = jax.tree_util.tree_map(lambda a: str(a.dtype), jparams)
    got_dtypes = tree_map(lambda t: str(t.dtype).replace("torch.", ""),
                          tparams)
    assert got_dtypes == want_dtypes
    _assert_tree_close(tparams, jparams, rtol=0, atol=0)


def test_serve_cli_runs_on_cpu_and_refuses_what_is_not_ported(monkeypatch):
    res = serve_mod.main(["--device", "cpu", "--smoke", "--batch", "2",
                          "--prompt-len", "8", "--gen", "3"])
    assert res["tokens"].shape == (2, 3)
    assert res["cache"]["length"].tolist() == [10, 10]
    with pytest.raises(SystemExit, match="no serving path"):
        serve_mod.build(serve_mod.parse_args(["--device", "cpu",
                                              "--arch", "fedtest-cnn"]))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        serve_mod.build(serve_mod.parse_args(["--smoke"]))
