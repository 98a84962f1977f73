"""Serving launcher: batched prefill + greedy decode against the KV/SSM
caches (port of ``repro.launch.serve``).

Usage:
    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-135m \
        --smoke --device cpu --batch 4 --prompt-len 32 --gen 16

Weights are random: ``models.convert.numpy_params(cfg, seed)``, the same
tree the reference can be fed, or with ``--device-fill``
``models.convert.device_fill`` (drawn on the device: other numbers, for
full-width runs on the card).  The prompt and the stub frontend inputs
are drawn from ``numpy.random.default_rng(seed)`` as the reference's
launcher draws them (:func:`random_batch`).  Without ``--device`` the
launcher runs on CUDA and raises where there is none.

ROADMAP Fault F15: the reference's launcher decodes an encoder-decoder
without the encoder output (its ``prefill`` does not return it and its
``decode_step`` call passes none), so each decoder layer's
cross-attention attends over the decoded token alone.  :func:`serve`
reproduces that; ``transformer.decode_step`` itself takes and honours
``enc_out`` / ``enc_pos``.

``--temperature`` is parsed and never read, as in the reference's
launcher: decoding is greedy whatever its value.
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, NamedTuple, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.launch.steps import make_decode_step, make_prefill_step
from repro_torch.models import transformer as T
from repro_torch.models.convert import (device_fill, numpy_params,
                                        params_from_reference)


class ServeResult(NamedTuple):
    tokens: np.ndarray     # (B, gen) greedy tokens
    prefill_s: float
    decode_s: float


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def prefix_len(cfg) -> int:
    """Positions the stub vision prefix takes before the prompt."""
    return cfg.frontend_seq if cfg.frontend == "vision" else 0


@torch.inference_mode()
def serve(model: T.Transformer, batch: Dict[str, torch.Tensor],
          gen: int) -> ServeResult:
    """Prefill ``batch`` (its ``tokens`` (B, S) and the config's stub
    inputs) and decode ``gen`` greedy tokens, through
    ``launch.steps.make_prefill_step`` and ``make_decode_step``.

    As in the reference, the token fed to each decode step is recorded,
    so the result holds the prefill's greedy token and ``gen - 1``
    decoded ones; the decode positions and ``max_len`` count a vision
    prefix, and an encoder-decoder decodes without its encoder output
    (F15, see the module's docstring).  Times are host seconds around
    work that ends in a device synchronize.
    """
    prompt = batch["tokens"]
    dev = prompt.device
    s = prompt.shape[1] + prefix_len(model.cfg)
    prefill, decode = make_prefill_step(model, s + gen), make_decode_step(model)
    _sync(dev)
    t0 = time.perf_counter()
    logits, caches = prefill(batch)
    tok = logits.argmax(dim=-1)[:, None]
    _sync(dev)
    t_prefill = time.perf_counter() - t0

    out = []
    t0 = time.perf_counter()
    for i in range(gen):
        out.append(tok[:, 0])
        logits, caches = decode(tok, caches, s + i)
        tok = logits.argmax(dim=-1)[:, None]
    _sync(dev)
    t_decode = time.perf_counter() - t0
    tokens = (torch.stack(out, dim=1).cpu().numpy() if out
              else np.zeros((prompt.shape[0], 0), np.int64))
    return ServeResult(tokens, t_prefill, t_decode)


def random_batch(cfg, batch: int, prompt_len: int, seed: int,
                 device) -> Dict[str, torch.Tensor]:
    """The prompt, then the config's stub inputs, from one
    ``default_rng(seed)`` in the reference launcher's order: ``tokens``
    (B, prompt_len), ``enc_embeds`` (B, prompt_len // 4, d) for an
    encoder-decoder, ``prefix_embeds`` (B, frontend_seq, d) for the
    vision frontend (f32 normals)."""
    rng = np.random.default_rng(seed)
    out = {"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab, (batch, prompt_len))).to(device)}

    def normal(n):
        return torch.from_numpy(rng.standard_normal(
            (batch, n, cfg.d_model)).astype(np.float32)).to(device)
    if cfg.is_enc_dec:
        out["enc_embeds"] = normal(prompt_len // 4)
    if cfg.frontend == "vision":
        out["prefix_embeds"] = normal(cfg.frontend_seq)
    return out


def main(argv: Optional[Sequence[str]] = None) -> ServeResult:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="accepted and not read: decoding is greedy at "
                         "any value, as the reference's launcher's is")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device-fill", action="store_true",
                    help="draw the weights on the device "
                         "(models.convert.device_fill)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=args.smoke)
    if args.device_fill:
        model = device_fill(T.Transformer(cfg, dev), args.seed)
    else:
        model = params_from_reference(cfg, numpy_params(cfg, args.seed),
                                      dev)
    batch = random_batch(cfg, args.batch, args.prompt_len, args.seed, dev)
    res = serve(model, batch, args.gen)
    print(f"{cfg.name}: prefill {args.batch}x{args.prompt_len} in "
          f"{res.prefill_s:.2f}s; {args.gen} decode steps in "
          f"{res.decode_s:.2f}s "
          f"({args.gen * args.batch / max(res.decode_s, 1e-9):.1f} tok/s) "
          f"on {dev}")
    print("first sequence:", res.tokens[0].tolist())
    return res


if __name__ == "__main__":
    main()
