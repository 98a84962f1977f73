"""Plain PyTorch versions of the port's kernels (the correctness contract).

``tat_lookup_ref`` and ``flash_attention_ref`` are ports of the
functions of the same names in ``repro.kernels.ref``; ``ssd_scan_ref``
is the port of ``repro.models.ssm.ssd_chunked`` (which the reference's
``ssd_scan_ref`` calls), kept here so that ``models.ssm`` can use it
without a circular import.  The plain version of the cell-scan kernel
is the eager ``repro_torch.core.engine.step.scan_cell``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def tat_lookup_ref(req_tags: torch.Tensor, tat: torch.Tensor,
                   states: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fully-associative lookup.

    req_tags: (R,) int32 request tags
    tat:      (N,) int32 table tags
    states:   (N,) int32 entry states (0 = Empty — an Empty entry never
              matches, mirroring PBCS semantics)
    Returns (idx: (R,) int32 first match index or -1,
             state: (R,) int32 matched entry's state or 0).
    """
    match = (req_tags[:, None] == tat[None, :]) & (states[None, :] != 0)
    has = match.any(dim=1)
    idx = torch.argmax(match.to(torch.int8), dim=1)
    st = torch.where(has, states[idx], torch.zeros_like(states[idx]))
    return (torch.where(has, idx, torch.full_like(idx, -1)).to(torch.int32),
            st.to(torch.int32))


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True,
                        window: Optional[int] = None) -> torch.Tensor:
    """Masked softmax attention.  q: (B, H, S, D), k/v: (B, Hkv, S, D).

    ``Hkv`` divides ``H``; query head ``h`` reads KV head ``h // (H //
    Hkv)`` (the reference model's GQA grouping).  With ``Hkv == H`` this
    is the reference's contract exactly.
    """
    s = q.shape[2]
    g = q.shape[1] // k.shape[1]
    if g > 1:
        k = k.repeat_interleave(g, dim=1)
        v = v.repeat_interleave(g, dim=1)
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    qp = torch.arange(s, device=q.device)[:, None]
    kp = torch.arange(s, device=q.device)[None, :]
    mask = torch.ones((s, s), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kp <= qp
    if window is not None:
        mask &= kp > qp - window
    logits = logits.masked_fill(~mask, torch.finfo(torch.float32).min)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", probs, v.float())
    return out.to(q.dtype)


def _segsum(log_a: torch.Tensor) -> torch.Tensor:
    """Stable segment-sum: out[..., i, j] = sum_{k=j+1..i} log_a[..., k]."""
    q = log_a.shape[-1]
    cs = torch.cumsum(log_a, dim=-1)
    out = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool,
                                 device=log_a.device))
    return out.masked_fill(~mask, -torch.inf)


def ssd_scan_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                 B: torch.Tensor, C: torch.Tensor, *, chunk: int = 128,
                 init_state: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan (port of ``repro.models.ssm.ssd_chunked``).

    x:  (B, S, H, P)   input heads
    dt: (B, S, H)      positive step sizes
    A:  (H,)           negative decay rates
    B:  (B, S, N)      input->state projection (shared across heads, g=1)
    C:  (B, S, N)      state->output projection
    init_state: (B, H, P, N) or None (zeros)
    Returns (y: (B,S,H,P) in x's dtype, final_state: (B,H,P,N) f32).
    """
    b, s, h, p = x.shape
    n = B.shape[-1]
    if s % chunk:
        # pad to a chunk multiple with dt=0 steps (exact identity: decay
        # exp(0)=1 and zero input contribution), then slice the result.
        pad = chunk - s % chunk
        y, final = ssd_scan_ref(
            F.pad(x, (0, 0, 0, 0, 0, pad)), F.pad(dt, (0, 0, 0, pad)), A,
            F.pad(B, (0, 0, 0, pad)), F.pad(C, (0, 0, 0, pad)),
            chunk=chunk, init_state=init_state)
        return y[:, :s], final
    nc = s // chunk
    f32 = torch.float32

    xc = x.to(f32).reshape(b, nc, chunk, h, p)
    dtc = dt.to(f32).reshape(b, nc, chunk, h)
    Bc = B.to(f32).reshape(b, nc, chunk, n)
    Cc = C.to(f32).reshape(b, nc, chunk, n)
    dA = dtc * A[None, None, None, :]            # (b,nc,q,h) log-decay

    # intra-chunk (dual/attention form)
    seg = _segsum(dA.movedim(-1, -2))             # (b,nc,h,q,q)
    L = torch.exp(seg)
    scores = torch.einsum("bcqn,bckn->bcqk", Cc, Bc)        # (b,nc,q,q)
    CB = scores[:, :, None, :, :] * L                       # (b,nc,h,q,k)
    y_diag = torch.einsum("bchqk,bckh,bckhp->bcqhp", CB, dtc, xc)

    # chunk summaries: decayed input->state
    dA_cum = torch.cumsum(dA, dim=2)              # (b,nc,q,h)
    decay_to_end = torch.exp(dA_cum[:, :, -1:, :] - dA_cum)
    states = torch.einsum("bcqn,bcqh,bcqhp->bchpn",
                          Bc, dtc * decay_to_end, xc)       # (b,nc,h,p,n)

    # inter-chunk recurrence over chunk states (the reference's lax.scan)
    chunk_decay = torch.exp(dA_cum[:, :, -1, :])  # (b,nc,h)
    carry = (torch.zeros((b, h, p, n), dtype=f32, device=x.device)
             if init_state is None else init_state.to(f32))
    prev = []
    for c in range(nc):
        prev.append(carry)                        # state BEFORE chunk c
        carry = carry * chunk_decay[:, c, :, None, None] + states[:, c]
    prev_states = torch.stack(prev, dim=1)        # (b,nc,h,p,n)

    # contribution of the carried-in state to each position
    state_decay = torch.exp(dA_cum)               # (b,nc,q,h)
    y_off = torch.einsum("bcqn,bcqh,bchpn->bcqhp", Cc, state_decay,
                         prev_states)

    y = (y_diag + y_off).reshape(b, s, h, p)
    return y.to(x.dtype), carry
