"""Multi-pod dry-run: run every (arch x shape x mesh) step on stand-ins
and count what one device would do (the port's side of
``repro/launch/dryrun.py``).

For each combination this script:
  1. builds the production mesh (one pod (data=32, model=8) or two
     (pod=2, data=32, model=8), ``launch/mesh.py``) over a ``"fake"``
     process group: no device, no peer;
  2. makes fake-tensor stand-ins for params / optimizer state / batch /
     KV-cache (nothing allocated) and distributes them as DTensors with
     the spec trees' placements (``launch/specs.py``);
  3. runs the step (``launch/steps.py``) under the activation rules
     (``sharding.logical_rules``), DTensor's sharding propagation
     inserting the collectives the reference's SPMD partitioner does; an
     op DTensor cannot shard, or a placement that does not fit, raises
     and the combination is recorded as ``error``;
  4. counts one device's FLOPs, bytes, collectives and peak intermediate
     bytes (``roofline.CostCounter``) and records them with the roofline
     terms on the card's ``Chip`` (``roofline.H100_SXM``) into a JSON
     artifact.

The layer stacks are Python loops, so every layer is counted: the depth
extrapolation (2 and 4 units, linear) equals the full-depth count, and
is kept because ``launch/perf.py`` calls it. Like the reference's, the
dry-run touches no device.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen2-72b --shape train_4k \\
      --mesh single
  python -m repro_torch.launch.dryrun --all --out experiments/dryrun_torch \\
      --resume
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback
from typing import Optional

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.config import INPUT_SHAPES, InputShape, TrainConfig
from repro_torch.configs import get_config, list_configs
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
from repro_torch.launch.specs import (
    activation_rules, batch_spec_tree, cache_spec_tree, cache_specs,
    distribute, input_specs, model_for, param_sharding_tree,
    params_and_opt_specs, supported)
from repro_torch.launch.steps import (
    make_decode_step, make_prefill_step, make_train_step)
from repro_torch.roofline import (
    H100_SXM, CostCounter, model_flops, roofline_terms)
from repro_torch.sharding import logical_rules

ASSIGNED = [a for a in list_configs() if not a.startswith("fedtest-")]
MESHES = ("single", "multi", "host")


def _layer_period(cfg) -> int:
    from repro_torch.models.decoder import _period
    return _period(cfg) if cfg.family != "encdec" else 1


def _with_depth(cfg, n_units: int):
    """Reduced-depth variant of the same config (n_units layer units)."""
    period = _layer_period(cfg)
    kw = {"num_layers": n_units * period}
    if cfg.family == "encdec":
        kw["encoder_layers"] = n_units
    return cfg.replace(**kw)


def mesh_context(mesh: str):
    """The named mesh as a context manager (see ``launch/mesh.py``)."""
    if mesh == "host":
        return make_host_mesh()
    return make_production_mesh(multi_pod=mesh == "multi")


def _local_bytes(tree) -> int:
    from torch.distributed.tensor import DTensor
    from torch.utils._pytree import tree_leaves
    total = 0
    for t in tree_leaves(tree):
        local = t._local_tensor if isinstance(t, DTensor) else t
        total += local.numel() * local.element_size()
    return total


def _opt_specs(opt_state, p_spec):
    """m/v mirror param specs; scalar counters replicate."""
    def build(node):
        if isinstance(node, dict):
            out = {}
            for k, v in node.items():
                if k in ("m", "v", "mu"):
                    out[k] = p_spec
                elif k == "step":
                    out[k] = ()
                else:
                    out[k] = build(v)
            return out
        return node

    return build(opt_state) if isinstance(opt_state, dict) else opt_state


def _lower_compile(cfg, shape, mesh, train_cfg=None, rules_override=None,
                   model_kw=None, param_transform=None):
    """One counted run of the step on ``mesh``; returns raw per-device
    counts. ``model_kw`` overrides model fields, ``param_transform`` maps
    the param spec tree (a perf variant's knobs)."""
    from torch.distributed.tensor.experimental import implicit_replication
    model = model_for(cfg, shape, **(model_kw or {}))
    train_cfg = train_cfg or TrainConfig()
    rules = dict(activation_rules(cfg, shape, mesh))
    if rules_override:
        rules.update(rules_override)
    mode = FakeTensorMode()

    t0 = time.time()
    params, opt_state = params_and_opt_specs(cfg, shape, train_cfg,
                                             mode=mode)
    p_spec = param_sharding_tree(cfg, mesh, params)
    if param_transform is not None:
        p_spec = param_transform(p_spec)
    batch = input_specs(cfg, shape, mode=mode)
    b_spec = batch_spec_tree(cfg, shape, mesh, batch)
    args = [distribute(mesh, p_spec, params, mode)]
    if shape.kind == "train":
        step, _ = make_train_step(model, train_cfg)
        args.append(distribute(mesh, _opt_specs(opt_state, p_spec),
                               opt_state, mode))
    elif shape.kind == "prefill":
        step = make_prefill_step(model, cache_len=shape.seq_len)
    else:
        step = make_decode_step(model)
        cache = cache_specs(cfg, shape, mode=mode)
        args.append(distribute(mesh, cache_spec_tree(cfg, shape, mesh,
                                                     cache), cache, mode))
    args.append(distribute(mesh, b_spec, batch, mode))
    t_lower = time.time() - t0

    counter = CostCounter()
    counter.track_inputs(args)
    with mode, implicit_replication(), logical_rules(rules), counter:
        out = step(*args)
    t_trace = time.time() - t0 - t_lower
    counts = counter.summary()
    rec = {
        "flops": counts["flops"],
        "bytes": counts["bytes"],
        "collectives": counts["collectives"],
        "coll_bytes": counts["coll_bytes"],
        "ops": counts["ops"],
        "memory": {
            "argument_bytes": _local_bytes(args),
            "output_bytes": _local_bytes(out),
            "temp_bytes": counts["peak_temp_bytes"],
            "alias_bytes": None,
        },
        "lower_s": round(t_lower, 1),
        "trace_s": round(t_trace, 1),
        "num_chips": mesh.size(),
    }
    return rec


def extrapolated_costs(cfg, shape, mesh, train_cfg=None,
                       rules_override=None, n1: int = 2, n2: int = 4,
                       **knobs):
    """Linear depth extrapolation of flops / bytes / collective bytes
    from ``n1`` and ``n2`` layer units to the config's depth."""
    period = _layer_period(cfg)
    units_full = (cfg.num_layers // period if cfg.family != "encdec"
                  else cfg.num_layers)
    f1 = _lower_compile(_with_depth(cfg, n1), shape, mesh, train_cfg,
                        rules_override, **knobs)
    f2 = _lower_compile(_with_depth(cfg, n2), shape, mesh, train_cfg,
                        rules_override, **knobs)
    out = {}
    for key in ("flops", "bytes", "coll_bytes"):
        delta = (f2[key] - f1[key]) / (n2 - n1)
        out[key] = f1[key] + (units_full - n1) * delta
        out[key + "_per_unit"] = delta
    colls = {}
    for op in set(f1["collectives"]) | set(f2["collectives"]):
        a, b = f1["collectives"].get(op, 0), f2["collectives"].get(op, 0)
        colls[op] = a + (units_full - n1) * (b - a) / (n2 - n1)
    out["collectives"] = colls
    out["extra_trace_s"] = f1["trace_s"] + f2["trace_s"]
    return out


def _shape(shape) -> InputShape:
    return INPUT_SHAPES[shape] if isinstance(shape, str) else shape


def lower_one(arch: str, shape, multi_pod: bool = False,
              train_cfg=None, rules_override=None,
              extrapolate: bool = True, mesh: Optional[str] = None):
    """One combination's record. ``shape`` is a name of ``INPUT_SHAPES``
    or an ``InputShape``; ``mesh`` ("single", "multi", "host") overrides
    ``multi_pod``."""
    cfg = get_config(arch)
    shape = _shape(shape)
    mesh_name = mesh or ("multi" if multi_pod else "single")
    ok, why = supported(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape.name, "mesh": mesh_name,
                "status": "skipped", "reason": why}

    with mesh_context(mesh_name) as dmesh:
        full = _lower_compile(cfg, shape, dmesh, train_cfg, rules_override)
        if extrapolate:
            costs = extrapolated_costs(cfg, shape, dmesh, train_cfg,
                                       rules_override)
        else:
            costs = {k: full[k] for k in ("flops", "bytes", "coll_bytes",
                                          "collectives")}

    n_chips = full["num_chips"]
    terms = roofline_terms(costs["flops"], costs["bytes"],
                           costs["coll_bytes"], H100_SXM, n_chips)
    mf = model_flops(cfg, shape)
    useful = mf / n_chips / max(costs["flops"], 1.0)
    return {
        "arch": arch, "shape": shape.name, "mesh": mesh_name,
        "status": "ok",
        "num_chips": n_chips,
        "chip": H100_SXM.name,
        "lower_s": full["lower_s"], "trace_s": full["trace_s"],
        "memory": full["memory"],
        "cost": {"flops_per_device": costs["flops"],
                 "bytes_per_device": costs["bytes"],
                 "raw_full_trace_flops": full["flops"],
                 "ops": full["ops"],
                 "extrapolated": extrapolate},
        "collectives": costs["collectives"],
        "collective_bytes_per_device": costs["coll_bytes"],
        "roofline": terms,
        "model_flops_global": mf,
        "useful_flops_ratio": useful,
        "params": cfg.param_count(),
        "active_params": cfg.active_param_count(),
    }


def run_combo(arch: str, shape: str, mesh: str, extrapolate: bool):
    """``lower_one``, a failure recorded as ``status: "error"`` with its
    traceback (a failure here is a framework bug)."""
    try:
        return lower_one(arch, shape, extrapolate=extrapolate, mesh=mesh)
    except Exception as e:
        return {"arch": arch, "shape": shape, "mesh": mesh,
                "status": "error", "error": repr(e),
                "traceback": traceback.format_exc()}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=sorted(INPUT_SHAPES))
    ap.add_argument("--mesh", default="single", choices=MESHES)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--resume", action="store_true",
                    help="skip combos whose artifact already exists")
    ap.add_argument("--no-extrapolate", action="store_true",
                    help="skip the depth-extrapolation runs (multi-pod "
                         "runs only need to run)")
    args = ap.parse_args(argv)
    if not args.all and not (args.arch and args.shape):
        ap.error("give --arch and --shape, or --all")

    torch.set_num_threads(1)
    os.makedirs(args.out, exist_ok=True)
    combos = []
    if args.all:
        for arch in ASSIGNED:
            for shape in INPUT_SHAPES:
                for mesh in ("single", "multi"):
                    combos.append((arch, shape, mesh))
    else:
        combos = [(args.arch, args.shape, args.mesh)]

    failed = 0
    for arch, shape, mesh in combos:
        tag = f"{arch}__{shape}__{mesh}".replace("/", "_")
        path = os.path.join(args.out, tag + ".json")
        if args.resume and os.path.exists(path):
            print(f"[skip existing] {tag}")
            continue
        print(f"[dryrun] {tag} ...", flush=True)
        t0 = time.time()
        # roofline extrapolation is a single-pod deliverable; the
        # multi-pod pass proves the "pod" axis shards & runs
        extrap = (mesh == "single") and not args.no_extrapolate
        rec = run_combo(arch, shape, mesh, extrap)
        rec["wall_s"] = round(time.time() - t0, 2)
        with open(path, "w") as f:
            json.dump(rec, f, indent=1)
        status = rec["status"]
        failed += status == "error"
        extra = ""
        if status == "ok":
            r = rec["roofline"]
            extra = (f" chips={rec['num_chips']} "
                     f"flops={rec['cost']['flops_per_device']:.4e} "
                     f"bytes={rec['cost']['bytes_per_device']:.4e} "
                     f"coll={rec['collective_bytes_per_device']:.4e} "
                     f"compute={r['compute_s']:.2e}s "
                     f"mem={r['memory_s']:.2e}s "
                     f"coll_s={r['collective_s']:.2e}s "
                     f"bn={r['bottleneck']} "
                     f"useful={rec['useful_flops_ratio']:.2f}")
        elif status == "error":
            extra = " " + rec["error"][:200]
        print(f"[{status}] {tag}{extra} wall={rec['wall_s']}s", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
