"""Batched serving entry point of the port: prefill a prompt batch, then
decode token by token (the decoder-LM side of ``repro.launch.serve``).

Serves any LM of the registry (dense, moe, Mamba2, hybrid, whisper's
encoder-decoder, pixtral's vlm) at full width on the card by default,
with weights drawn from ``--seed``:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-0.5b \\
      --batch 8 --prompt-len 512 --gen 32
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-2.7b \\
      --batch 8 --prompt-len 512 --gen 32
  PYTHONPATH=src python -m repro_torch.launch.serve \\
      --arch granite-moe-1b-a400m --batch 8 --prompt-len 512 --gen 32
  PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-base \\
      --batch 8 --prompt-len 384 --gen 32
  PYTHONPATH=src python -m repro_torch.launch.serve --arch pixtral-12b \\
      --batch 8 --prompt-len 512 --gen 32

Prefill runs each attention layer through the ``flash_attention``
kernel, decode through ``decode_attention``; prefill runs each mamba
layer's scan through the ``ssd_scan`` kernel and decode steps the
recurrence in plain torch. A MoE layer routes the prefill by capacity
(groups of 512 tokens) and decode dropless, as the reference's server
does. whisper encodes stub frames (``[B, 1500, 512]``) and its decoder
attends them through ``flash_attention`` in the prefill and in every
decode step; its learned position table is extended to ``prompt + gen +
1`` rows where that exceeds its 448, as the reference's server extends
it. pixtral's prompt is its stub patches (1,024 a sequence) before the
text, and its cache holds both. ``--device cpu --smoke`` runs the
reduced config in f32 on the CPU (the kernels' plain versions);
``--device cuda`` without a card raises. Prompt tokens, the stub frames
or patches (drawn after the tokens) and sampling come from a
``torch.Generator``, so they differ from the reference's JAX draws.

Serve-while-training (DESIGN.md §9): with ``--ckpt-dir`` the server
waits up to ``--wait-secs`` for a checkpoint of the port's
``CheckpointManager``, refuses one of another arch, and serves the
global params of the newest one that loads (saves are atomic, so it
never reads a torn file):

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-0.5b \\
      --ckpt-dir ckpt --wait-secs 60
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, List

import torch

from repro_torch.checkpoint import (
    CheckpointManager, params_tree, read_leaves)
from repro_torch.config import LM_FAMILIES, reduce_for_smoke
from repro_torch.configs import get_config, list_configs
from repro_torch.convert import params_from_reference
from repro_torch.core.engine import resolve_device
from repro_torch.models import build_model
from repro_torch.models.frontend_stub import stub_embeddings

# seconds between looks for a first checkpoint under --wait-secs
POLL_S = 0.5


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b", choices=list_configs())
    ap.add_argument("--smoke", action="store_true",
                    help="the reduced config (reduce_for_smoke) in f32")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the run; 'cuda' raises when no "
                         "card is present")
    ap.add_argument("--ckpt-dir", default=None,
                    help="serve the newest checkpoint of a (possibly still "
                         "running) training run instead of weights drawn "
                         "from --seed")
    ap.add_argument("--wait-secs", type=float, default=0.0,
                    help="poll --ckpt-dir this long for a first checkpoint "
                         "before giving up")
    args = ap.parse_args(argv)
    if args.gen < 1 or args.prompt_len < 1 or args.batch < 1:
        ap.error("--batch, --prompt-len and --gen must be positive")
    return args


def load_serving_params(mgr: CheckpointManager, model, arch: str = None,
                        wait_secs: float = 0.0, *, device):
    """``(global_params, step)`` of the newest checkpoint in ``mgr`` whose
    params load into ``model``, polled for up to ``wait_secs``; the params
    on ``device`` (required: no default device) in the model's dtypes.
    Only the ``.global_params/`` leaves are read, so the rest of the round
    state (and the run's ``FedConfig``) is not needed; a manifest beside
    the checkpoints that names another arch is refused."""
    deadline = time.time() + wait_secs
    while mgr.latest_step() is None:
        if time.time() >= deadline:
            raise FileNotFoundError(
                f"no checkpoint appeared in {mgr.directory} within "
                f"{wait_secs:.0f}s")
        time.sleep(POLL_S)
    saved_arch = (mgr.read_manifest() or {}).get("arch")
    if arch is not None and saved_arch is not None and saved_arch != arch:
        raise SystemExit(
            f"checkpoint dir holds arch {saved_arch!r}, server was asked "
            f"to serve {arch!r} — refusing")
    return mgr.load_newest(lambda path: params_from_reference(
        params_tree(read_leaves(path)), device, model=model))


def build(args: argparse.Namespace, **overrides):
    """(model, params, prompt batch, generator) for the parsed flags, on
    the run's device. The batch holds ``tokens`` [B, S] int32 and, for
    whisper, ``frames`` [B, encoder_seq, D] or, for a vlm, ``patches``
    [B, num_patches, D] in the model's dtype, drawn by ``stub_embeddings``
    after the tokens. With ``--ckpt-dir`` the params are the newest
    checkpoint's and the tokens are drawn from ``--seed`` as the first
    draw. ``overrides`` replace fields of the arch's config (a cut of its
    depth or widths) before ``--smoke``. An encdec's position table gets
    ``prompt + gen + 1`` rows where that exceeds its own, as the
    reference's server gives it."""
    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if overrides:
        cfg = cfg.replace(**overrides)
    if args.smoke:
        cfg = reduce_for_smoke(cfg).replace(dtype="float32")
    if cfg.family not in LM_FAMILIES:
        raise SystemExit(f"{cfg.name} ({cfg.family}) has no serving path")
    model = build_model(cfg, max_target_positions=args.prompt_len
                        + args.gen + 1)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    if args.ckpt_dir:
        params, step = load_serving_params(
            CheckpointManager(args.ckpt_dir), model, arch=cfg.name,
            wait_secs=args.wait_secs, device=device)
        print(f"serving round-{step} weights from {args.ckpt_dir}")
    else:
        params = model.init(gen)
    batch = {"tokens": torch.randint(0, cfg.vocab_size,
                                     (args.batch, args.prompt_len),
                                     generator=gen, device=device,
                                     dtype=torch.int32)}
    stub = {"encdec": "frames", "vlm": "patches"}.get(cfg.family)
    if stub:
        batch[stub] = stub_embeddings(cfg, args.batch, gen, model.dtype)
    return model, params, batch, gen


def sample(logits: torch.Tensor, temperature: float,
           gen: torch.Generator) -> torch.Tensor:
    """Next tokens [B, 1] int32 from the last position's logits: greedy at
    temperature 0, else drawn from softmax(logits / temperature)."""
    last = logits[:, -1].float()
    if temperature <= 0:
        tok = last.argmax(dim=-1)
    else:
        tok = torch.multinomial(torch.softmax(last / temperature, dim=-1), 1,
                                generator=gen)[:, 0]
    return tok[:, None].to(torch.int32)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def cache_capacity(model, prompt_len: int, gen_len: int) -> int:
    """Cache rows a sequence for a prompt and ``gen_len`` tokens: a vlm's
    patches too, and one spare row, as the reference's server sizes it."""
    cfg = model.cfg
    return (prompt_len + gen_len + 1
            + (cfg.num_patches if cfg.family == "vlm" else 0))


def serve(model, params, batch: Dict[str, torch.Tensor], gen_len: int,
          temperature: float, gen: torch.Generator,
          on_step=None) -> Dict[str, object]:
    """Prefill ``batch`` (``tokens`` [B, S] and a model's stub ``frames``
    or ``patches``), then decode ``gen_len - 1`` more tokens (the first
    comes from the prefill's logits). ``on_step(i, logits)`` sees the
    prefill's logits (i = 0) and each decode step's (i >= 1). Returns
    the generated tokens [B, gen_len], the cache and the host-clock
    times, each ending in a device synchronisation."""
    S = batch["tokens"].shape[1]
    device = batch["tokens"].device
    cap = cache_capacity(model, S, gen_len)
    _sync(device)
    t0 = time.perf_counter()
    logits, cache = model.prefill(params, batch, cache_len=cap)
    _sync(device)
    t_prefill = time.perf_counter() - t0
    if on_step is not None:
        on_step(0, logits)
    toks = sample(logits, temperature, gen)
    out: List[torch.Tensor] = [toks]
    t0 = time.perf_counter()
    for i in range(gen_len - 1):
        logits, cache = model.decode_step(params, cache, toks)
        if on_step is not None:
            on_step(i + 1, logits)
        toks = sample(logits, temperature, gen)
        out.append(toks)
    _sync(device)
    t_decode = time.perf_counter() - t0
    return {"tokens": torch.cat(out, dim=1), "prefill_s": t_prefill,
            "decode_s": t_decode, "cache": cache}


def main(argv=None):
    args = parse_args(argv)
    model, params, batch, gen = build(args)
    B, S = batch["tokens"].shape
    res = serve(model, params, batch, args.gen, args.temperature, gen)
    t_prefill, t_decode = res["prefill_s"], res["decode_s"]
    steps = args.gen - 1
    print(f"arch={model.cfg.name} batch={B} prompt={S} gen={args.gen} "
          f"device={batch['tokens'].device}")
    print(f"prefill: {t_prefill * 1e3:.1f} ms "
          f"({B * S / max(t_prefill, 1e-9):.0f} tok/s)")
    print(f"decode : {t_decode * 1e3:.1f} ms "
          f"({t_decode * 1e3 / max(steps, 1):.2f} ms/step, "
          f"{B * steps / max(t_decode, 1e-9):.1f} tok/s)")
    print("sample tokens:", res["tokens"][0, :12].tolist())
    return res


if __name__ == "__main__":
    main()
