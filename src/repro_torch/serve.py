"""Batched serving: prefill a batch of prompts, then greedy decode with a
shared KV cache (twin of ``examples/serve.py``); an encoder-only model
(hubert-xlarge) encodes instead: one prefill that gives the frame logits.

    PYTHONPATH=src python -m repro_torch.serve --arch qwen3-1.7b \
        [--reduced] [--device cpu] [--dtype bf16]

Runs on the GPU unless ``--device cpu`` is given; with no GPU it raises.
Weights are random, drawn from a fixed seed.  A model with a frontend stub
(hubert-xlarge, pixtral-12b) reads a prompt of pseudo-embeddings
(``data.pseudo_embeds``) in place of tokens.
"""
from __future__ import annotations

import argparse
import time
from dataclasses import dataclass

import torch

from repro_torch import resolve_device
from repro_torch.configs import ARCHS, get_config
from repro_torch.data import pseudo_embeds
from repro_torch.models import lm

DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


@dataclass
class Generation:
    tokens: torch.Tensor          # (B, new_tokens) greedy tokens
    prefill_logits: torch.Tensor  # (B, V) f32 logits of the prompt's last position
    prefill_s: float              # prefill and its argmax, host clock after a sync
    decode_s: float               # the new_tokens - 1 decode steps, likewise


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclass
class Encoding:
    logits: torch.Tensor  # (B, S, V) f32 frame logits
    labels: torch.Tensor  # (B, S) their argmax
    prefill_s: float      # prefill and its argmax, host clock after a sync


def generate(params, cfg, prompts, new_tokens: int, *, cache_dtype,
             embeds=None) -> Generation:
    """Prefill ``prompts`` (B, P), or a prompt of ``embeds`` (B, P, d) with
    ``prompts`` None, and decode ``new_tokens`` tokens greedily."""
    if not cfg.has_decoder:
        raise ValueError(f"{cfg.name} is encoder-only: it has no decode step; use encode()")
    prompt = prompts if embeds is None else embeds
    B, P = prompt.shape[:2]
    device = prompt.device
    cache = lm.init_cache(cfg, B, P + new_tokens + 8, cache_dtype, device)
    _sync(device)
    t0 = time.perf_counter()
    logits, cache = lm.prefill(params, cfg, cache, tokens=prompts, embeds=embeds)
    cur = torch.argmax(logits, -1)[:, None]
    _sync(device)
    t1 = time.perf_counter()
    out = [cur]
    for _ in range(new_tokens - 1):
        step_logits, cache = lm.decode_step(params, cfg, cache, cur)
        cur = torch.argmax(step_logits, -1)[:, None]
        out.append(cur)
    _sync(device)
    t2 = time.perf_counter()
    return Generation(torch.cat(out, dim=1), logits, t1 - t0, t2 - t1)


def encode(params, cfg, embeds) -> Encoding:
    """An encoder-only model over ``embeds`` (B, S, d): its prefill, which
    gives the frame logits, and their argmax."""
    if cfg.has_decoder:
        raise ValueError(f"{cfg.name} has a decoder: use generate()")
    device = embeds.device
    _sync(device)
    t0 = time.perf_counter()
    logits, _ = lm.prefill(params, cfg, None, embeds=embeds)
    labels = torch.argmax(logits, -1)
    _sync(device)
    return Encoding(logits, labels, time.perf_counter() - t0)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b", choices=sorted(ARCHS))
    ap.add_argument("--reduced", action="store_true",
                    help="the architecture's small CPU-test config")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dtype", default="f32", choices=sorted(DTYPES))
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=24)
    ap.add_argument("--new-tokens", type=int, default=16)
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    dtype = DTYPES[args.dtype]
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    params = lm.init_params(cfg, torch.Generator(device).manual_seed(0), dtype, device)
    embeds = None
    if cfg.frontend:
        embeds = pseudo_embeds(args.batch, args.prompt_len, cfg.d_model, seed=1, step=0,
                               dtype=dtype, device=device)
    if not cfg.has_decoder:
        enc = encode(params, cfg, embeds)
        print(f"[serve] encoded {args.batch}x{args.prompt_len} frames in {enc.prefill_s:.2f}s")
        print("[serve] sample:", enc.labels[0, :16].tolist())
        return
    prompts = None if cfg.frontend else torch.randint(
        0, cfg.vocab, (args.batch, args.prompt_len),
        generator=torch.Generator(device).manual_seed(1), device=device)

    gen = generate(params, cfg, prompts, args.new_tokens, cache_dtype=dtype, embeds=embeds)
    print(f"[serve] prefill {args.batch}x{args.prompt_len} in {gen.prefill_s:.2f}s")
    print(f"[serve] decoded {args.new_tokens} tokens/seq x {args.batch} seqs "
          f"in {gen.decode_s:.2f}s ({args.batch * args.new_tokens / gen.decode_s:.1f} tok/s)")
    print("[serve] sample:", gen.tokens[0].tolist())


if __name__ == "__main__":
    main()
