"""Serving an LM of the zoo: batched prefill, then greedy token-by-token
decode with the KV / recurrent caches; the port of
``examples/serve_lm.py`` for the dense GQA transformer, its MoE variants
(mixtral, llama4), the attention-free RWKV6 and the Mamba2 +
shared-attention Zamba2 families.

    python -m repro_torch.launch.serve_lm                  # the three smoke archs, on the card
    python -m repro_torch.launch.serve_lm --arch qwen2.5-3b-smoke --device cpu

Runs on the card unless ``--device cpu`` is given. Weights and prompts
are random, drawn on the device from ``serve``'s seed (0 from the CLI).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config
from repro_torch.models.zoo import ModelAPI, get_api

ARCHS = ["qwen2.5-3b-smoke", "rwkv6-7b-smoke", "zamba2-7b-smoke"]


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def generate(api: ModelAPI, params, tokens: torch.Tensor, gen: int,
             forced: torch.Tensor | None = None):
    """Prefill ``tokens`` [B, S], then ``gen`` greedy decode steps.

    ``forced`` [B, gen] (optional) feeds those tokens instead of the
    argmax (teacher forcing), so that two runs can be compared step by
    step. Returns (tokens fed i64[B, gen], logits f32[B, gen + 1, V]: the
    prefill's last and each decode step's, decode seconds)."""
    logits, state = api.prefill(params, {"tokens": tokens},
                                tokens.shape[1] + gen)
    out, steps = [], [logits]
    _sync(tokens.device)
    t0 = time.perf_counter()
    for i in range(gen):
        tok = logits.argmax(-1) if forced is None else forced[:, i]
        out.append(tok)
        logits, state = api.decode(params, tok, state)
        steps.append(logits)
    _sync(tokens.device)
    return torch.stack(out, 1), torch.stack(steps, 1), \
        time.perf_counter() - t0


def serve(arch: str, batch: int = 4, prompt_len: int = 32, gen: int = 16,
          device="cuda", seed: int = 0) -> np.ndarray:
    """Serve ``batch`` random prompts of ``arch``; prints the decode rate
    and returns the generated tokens i64[batch, gen]."""
    dev = resolve_device(device)
    cfg = get_config(arch)
    api = get_api(cfg)
    g = torch.Generator(device=dev).manual_seed(seed)
    params = api.init(g, dev)
    prompts = torch.randint(0, cfg.vocab, (batch, prompt_len), generator=g,
                            device=dev)
    toks, _, wall = generate(api, params, prompts, gen)
    toks = toks.cpu().numpy()
    print(f"{arch:28s} generated {toks.shape} in {wall:.2f}s "
          f"({batch * gen / wall:,.0f} tok/s) on {dev} "
          f"sample={toks[0][:8].tolist()}")
    return toks


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", action="append",
                    help=f"arch to serve (repeatable; default {ARCHS})")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu only on request)")
    args = ap.parse_args(argv)
    for arch in args.arch or ARCHS:
        serve(arch, device=args.device)


if __name__ == "__main__":
    main()
