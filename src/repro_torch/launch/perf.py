"""Perf variant runner (the port's side of ``repro/launch/perf.py``).

Re-runs one (arch x shape) dry-run under a named variant — an
activation-rule override, a parameter-sharding mode, a model knob, or a
training knob — and reports the roofline-term deltas against the
baseline artifact in ``experiments/dryrun_torch`` when there is one.
Where the reference monkey-patches the dry-run's spec functions, the port
passes the variant's knobs to ``dryrun._lower_compile`` and
``dryrun.extrapolated_costs`` (``model_kw``, ``param_transform``).

Seven of the reference's variants set a knob the port has not:
``attn_impl="naive"`` (the port has one attention route a use)
and ``cache_update`` (the port's decode writes the cache row in place).
They are in :data:`NOT_PORTED` and raise ``ValueError``.

  PYTHONPATH=src python -m repro_torch.launch.perf --arch qwen2-72b \\
      --shape decode_32k --variant tp_only_params
"""
from __future__ import annotations

import argparse
import json
import os

from repro_torch.config import INPUT_SHAPES, TrainConfig
from repro_torch.configs import get_config
from repro_torch.launch import dryrun as dr
from repro_torch.roofline import H100_SXM, roofline_terms
from repro_torch.utils import tree_map

# name -> dict(rules=..., model_kw=..., train_kw=..., params=...)
VARIANTS = {
    "baseline": {},
    # ---- decode-side ideas ----
    # serve with tensor-parallel-only params (no FSDP regather per step)
    "tp_only_params": {"params": "tp_only"},
    # KV cache sequence dim spread over BOTH axes
    "kv_seq_2d": {"rules": {"kv_seq": ("data", "model")}},
    # KV cache sharded over batch only (heads/seq replicated)
    "kv_batch_only": {"rules": {"kv_seq": None}},
    # ---- train-side ideas ----
    "no_remat": {"train_kw": {"remat": False}},
    "sgd_momentum": {"train_kw": {"optimizer": "momentum"}},
    # keep activations' embed dim sharded over model after each block
    "embed_sharded": {"rules": {"embed": "model"}},
    # ---- moe ideas ----
    "moe_group_256": {"model_kw": {"moe_group_size": 256}},
    "moe_group_1024": {"model_kw": {"moe_group_size": 1024}},
    "moe_group_2048": {"model_kw": {"moe_group_size": 2048}},
    # decode: keep expert weights stationary (fully sharded over
    # model x data via the expert FFN dim) so serving never re-gathers
    # the expert bank
    "moe_stationary": {"params": "moe_stationary"},
    # train: Megatron-style sequence parallelism for the residual stream
    "seq_parallel": {"rules": {"seq": "model"}},
    # experts stationary AND the (much smaller) non-expert params kept
    # tensor-parallel-only: zero per-step weight gathers
    "serve_stationary_tp": {"params": "moe_stationary_tp"},
    # sequence-chunked cross-entropy: never materialise [B,S,V] fp32 logits
    "ce_chunked": {"model_kw": {"ce_chunk": 512}},
    "ce_chunked_noremat": {"model_kw": {"ce_chunk": 512},
                           "train_kw": {"remat": False}},
    # residual stream sharded over model + chunked CE
    "train_fit": {"rules": {"embed": "model"},
                  "model_kw": {"ce_chunk": 512}},
}

_NAIVE = ("sets attn_impl='naive', a knob the port does not have: its "
          "attention takes one route a use (the kernel op, or the "
          "blockwise twin in training and the dry-run)")
_CACHE = ("sets cache_update, a knob the port does not have: its decode "
          "writes the cache row in place")
# the reference's variants whose knob the port has not
NOT_PORTED = {
    "decode_naive_attn": _NAIVE,
    "serve_opt": _NAIVE,
    "decode_flash_layout": _NAIVE,
    "serve_opt2": _NAIVE,
    "decode_dus": _CACHE,
    "decode_onehot": _CACHE,
    "serve_opt3": f"{_NAIVE}; and {_CACHE}",
}


def remap_moe_stationary(spec_tree):
    """Expert banks fully sharded (E over model, FFN dim over data):
    w_gate/w_up [L,E,D,F] -> (None, model, None, data);
    w_down      [L,E,F,D] -> (None, model, data, None)."""
    if not isinstance(spec_tree, dict):
        return spec_tree
    out = {}
    for k, v in spec_tree.items():
        if k == "moe" and isinstance(v, dict):
            new = dict(v)
            for name in ("w_gate", "w_up"):
                if name in new:
                    new[name] = (None, "model", None, "data")
            if "w_down" in new:
                new["w_down"] = (None, "model", "data", None)
            out[k] = new
        else:
            out[k] = remap_moe_stationary(v)
    return out


def strip_fsdp_params(spec_tree):
    """Replace every non-'model' mesh axis in param specs with None."""
    def fix(spec):
        out = []
        for entry in spec:
            if entry is None:
                out.append(None)
            elif isinstance(entry, tuple):
                kept = tuple(a for a in entry if a == "model")
                out.append(kept[0] if len(kept) == 1 else (kept or None))
            else:
                out.append(entry if entry == "model" else None)
        return tuple(out)

    return tree_map(fix, spec_tree)


PARAM_MODES = {
    "fsdp": None,
    "tp_only": strip_fsdp_params,
    "moe_stationary": remap_moe_stationary,
    "moe_stationary_tp": lambda s: remap_moe_stationary(strip_fsdp_params(s)),
}


def variant(name: str) -> dict:
    """A variant's knobs; a variant not ported raises ``ValueError``."""
    if name in NOT_PORTED:
        raise ValueError(f"perf variant {name!r} is not ported: it "
                         f"{NOT_PORTED[name]}")
    if name not in VARIANTS:
        raise ValueError(f"unknown perf variant {name!r}; known: "
                         f"{sorted(VARIANTS)}")
    return VARIANTS[name]


def run_variant(arch, shape_name, variant_name, extrapolate=True):
    v = variant(variant_name)
    cfg = get_config(arch)
    shape = INPUT_SHAPES[shape_name]
    train_cfg = TrainConfig(**v.get("train_kw", {}))
    knobs = dict(model_kw=v.get("model_kw", {}),
                 param_transform=PARAM_MODES[v.get("params", "fsdp")])
    rules_override = v.get("rules")
    with dr.mesh_context("single") as mesh:
        full = dr._lower_compile(cfg, shape, mesh, train_cfg,
                                 rules_override, **knobs)
        if extrapolate:
            costs = dr.extrapolated_costs(cfg, shape, mesh, train_cfg,
                                          rules_override, **knobs)
        else:
            costs = {k: full[k] for k in ("flops", "bytes", "coll_bytes",
                                          "collectives")}

    terms = roofline_terms(costs["flops"], costs["bytes"],
                           costs["coll_bytes"], H100_SXM,
                           full["num_chips"])
    return {"arch": arch, "shape": shape_name, "variant": variant_name,
            "roofline": terms, "memory": full["memory"],
            "collectives": costs["collectives"],
            "cost": {"flops_per_device": costs["flops"],
                     "bytes_per_device": costs["bytes"]},
            "collective_bytes_per_device": costs["coll_bytes"],
            "trace_s": full["trace_s"]}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True, choices=sorted(INPUT_SHAPES))
    ap.add_argument("--variant", required=True,
                    choices=sorted(VARIANTS) + sorted(NOT_PORTED))
    ap.add_argument("--out", default="experiments/perf_torch")
    ap.add_argument("--no-extrapolate", action="store_true")
    args = ap.parse_args(argv)

    rec = run_variant(args.arch, args.shape, args.variant,
                      extrapolate=not args.no_extrapolate)
    os.makedirs(args.out, exist_ok=True)
    tag = f"{args.arch}__{args.shape}__{args.variant}"
    with open(os.path.join(args.out, tag + ".json"), "w") as f:
        json.dump(rec, f, indent=1)
    r = rec["roofline"]
    print(f"[perf] {tag}: compute={r['compute_s']:.3e} "
          f"memory={r['memory_s']:.3e} collective={r['collective_s']:.3e} "
          f"bottleneck={r['bottleneck']}")

    # diff against the baseline dry-run artifact when present
    base_path = os.path.join("experiments/dryrun_torch",
                             f"{args.arch}__{args.shape}__single.json")
    if os.path.exists(base_path) and args.variant != "baseline":
        with open(base_path) as f:
            base = json.load(f)
        if base.get("status") == "ok":
            b = base["roofline"]
            for k in ("compute_s", "memory_s", "collective_s"):
                delta = (r[k] - b[k]) / max(b[k], 1e-30) * 100
                print(f"   {k}: {b[k]:.3e} -> {r[k]:.3e}  ({delta:+.1f}%)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
