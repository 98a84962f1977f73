"""Serving launcher: batched prefill + greedy decode against the KV/SSM
caches (port of ``repro.launch.serve``).

Usage:
    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-135m \
        --smoke --device cpu --batch 4 --prompt-len 32 --gen 16

Weights are random: ``models.convert.numpy_params(cfg, seed)``, the same
tree the reference can be fed.  The prompt is drawn from
``numpy.random.default_rng(seed)``.  Without ``--device`` the launcher runs
on CUDA and raises where there is none.
"""
from __future__ import annotations

import argparse
import time
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.models import transformer as T
from repro_torch.models.convert import numpy_params, params_from_reference


class ServeResult(NamedTuple):
    tokens: np.ndarray     # (B, gen) greedy tokens
    prefill_s: float
    decode_s: float


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@torch.inference_mode()
def serve(model: T.Transformer, prompt: torch.Tensor,
          gen: int) -> ServeResult:
    """Prefill ``prompt`` (B, S) and decode ``gen`` greedy tokens.

    As in the reference, the token fed to each decode step is recorded,
    so the result holds the prefill's greedy token and ``gen - 1``
    decoded ones.  Times are host seconds around work that ends in a
    device synchronize.
    """
    dev = prompt.device
    s = prompt.shape[1]
    _sync(dev)
    t0 = time.perf_counter()
    logits, caches = T.prefill(model, {"tokens": prompt}, s + gen)
    tok = logits.argmax(dim=-1)[:, None]
    _sync(dev)
    t_prefill = time.perf_counter() - t0

    out = []
    t0 = time.perf_counter()
    for i in range(gen):
        out.append(tok[:, 0])
        logits, caches = T.decode_step(model, tok, caches, pos0=s + i)
        tok = logits.argmax(dim=-1)[:, None]
    _sync(dev)
    t_decode = time.perf_counter() - t0
    tokens = (torch.stack(out, dim=1).cpu().numpy() if out
              else np.zeros((prompt.shape[0], 0), np.int64))
    return ServeResult(tokens, t_prefill, t_decode)


def random_prompt(vocab: int, batch: int, prompt_len: int, seed: int,
                  device) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, vocab, (batch, prompt_len))
                            ).to(device)


def main(argv: Optional[Sequence[str]] = None) -> ServeResult:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if args.temperature != 0.0:
        raise NotImplementedError("only greedy decoding (temperature 0), "
                                  "as the reference does")

    dev = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=args.smoke)
    model = params_from_reference(cfg, numpy_params(cfg, args.seed), dev)
    prompt = random_prompt(cfg.vocab, args.batch, args.prompt_len,
                           args.seed, dev)
    res = serve(model, prompt, args.gen)
    print(f"{cfg.name}: prefill {args.batch}x{args.prompt_len} in "
          f"{res.prefill_s:.2f}s; {args.gen} decode steps in "
          f"{res.decode_s:.2f}s "
          f"({args.gen * args.batch / max(res.decode_s, 1e-9):.1f} tok/s) "
          f"on {dev}")
    print("first sequence:", res.tokens[0].tolist())
    return res


if __name__ == "__main__":
    main()
