"""The train, prefill and decode steps (port of ``repro.launch.steps``).

The reference's step is a pure function of (params, opt_state, batch);
the port's model holds its parameters, so the step updates them in place
and threads only the optimizer state.  Gradients are those of
``models.transformer.loss_fn``, whose attention is the model's own
masked softmax and whose SSD layers run ``models.ssm.ssd_chunked``: no
hand-written kernel runs in training, as none runs in the reference's
(its model never calls its Pallas kernels).

:func:`make_prefill_step` and :func:`make_decode_step` wrap
``transformer.prefill`` and ``decode_step`` as the reference's do; the
serve launcher and the dry-run call them.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import torch

from repro_torch.models import transformer as T
from repro_torch.models.convert import stack_layers, unstack_layers
from repro_torch.optim import AdamWConfig, adamw_update
from repro_torch.optim.compress import topk_compress_grads

Step = Callable[[Dict[str, Any], Dict[str, Any]],
                Tuple[Dict[str, Any], Dict[str, torch.Tensor]]]


def make_train_step(model: T.Transformer, opt_cfg: AdamWConfig,
                    compress_ratio: float = 0.0,
                    microbatches: int = 1) -> Step:
    """``(opt_state, batch) -> (opt_state, metrics)``, updating ``model``'s
    parameters in place; metrics ``loss``, ``grad_norm`` and ``lr``.

    ``batch`` holds ``tokens`` and ``labels`` (numpy or tensors).
    ``microbatches`` > 1 sums the gradients of equal batch slices in f32
    and divides, as the reference's ``lax.scan`` does.  With
    ``compress_ratio`` > 0 the gradients are top-k compressed per leaf of
    the reference's stacked layout (the threshold over all layers of a
    leaf, as the reference's), and the residual goes into
    ``opt_state["err"]`` in that layout, which ``adamw_update`` then
    drops from the state it returns: the reference does the same, so its
    error feedback never reaches the next step (ROADMAP Queue C, F13),
    and the port reproduces that.
    """
    cfg = model.cfg
    T.set_trainable(model, True)
    params = dict(model.named_parameters())
    dev = next(iter(params.values())).device

    def grads_of(batch):
        loss = T.loss_fn(model, batch)
        grads = torch.autograd.grad(loss, list(params.values()))
        return loss.detach(), dict(zip(params, grads))

    def step(opt_state, batch):
        batch = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
        if microbatches == 1:
            loss, grads = grads_of(batch)
        else:
            mb = {k: v.reshape((microbatches, v.shape[0] // microbatches)
                               + tuple(v.shape[1:]))
                  for k, v in batch.items()}
            loss = torch.zeros((), dtype=torch.float32, device=dev)
            grads = {n: torch.zeros(p.shape, dtype=torch.float32,
                                    device=dev) for n, p in params.items()}
            for i in range(microbatches):
                li, gi = grads_of({k: v[i] for k, v in mb.items()})
                loss = loss + li
                grads = {n: grads[n] + gi[n] for n in grads}
            loss = loss / microbatches
            grads = {n: g / microbatches for n, g in grads.items()}
        if compress_ratio > 0.0:
            comp, err = topk_compress_grads(
                stack_layers(cfg, grads), opt_state.get("err"),
                compress_ratio)
            grads = unstack_layers(cfg, comp)
            opt_state = dict(opt_state, err=err)
        with torch.no_grad():
            new, opt_state, metrics = adamw_update(
                opt_cfg, {n: p.detach() for n, p in params.items()}, grads,
                opt_state)
            for n, p in params.items():
                p.copy_(new[n])
        metrics["loss"] = loss
        return opt_state, metrics

    return step


def make_prefill_step(model: T.Transformer, max_len: int):
    """``batch -> (last position's logits, caches)`` with room for
    ``max_len`` positions."""
    def step(batch):
        return T.prefill(model, batch, max_len)
    return step


def make_decode_step(model: T.Transformer):
    """``(tokens_last, caches, pos0, enc_out=None, enc_pos=None) ->
    (logits, caches)``."""
    def step(tokens_last, caches, pos0, enc_out=None, enc_pos=None):
        return T.decode_step(model, tokens_last, caches, pos0=pos0,
                             enc_out=enc_out, enc_pos=enc_pos)
    return step
