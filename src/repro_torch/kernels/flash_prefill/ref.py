"""Plain PyTorch version of the flash_prefill kernel: dense grouped-query
attention with the masking of ``repro.models.attention.gqa_attention``
(causal, sliding window, always-visible prefix, per-row kv length), in
the same order of operations (scores in the input dtype, softmax in f32,
fully masked rows give 0)."""
from __future__ import annotations

import torch

__all__ = ["dense_ref"]


def dense_ref(q, k, v, *, causal=True, sliding_window=0, prefix_len=0,
              q_offset=0, kv_len=None, return_lse=False):
    """q [b, s, h, d]; k, v [b, t, g, d] -> [b, s, h, d].  ``q_offset`` is
    the absolute position of q[:, 0] (int or [b]); ``kv_len`` [b] bounds
    the valid keys per row.  ``return_lse`` adds each row's log-sum-exp of
    its scaled scores, [b, h, s] f32 (-inf for a fully masked row)."""
    b, s, h, d = q.shape
    t, g = k.shape[1], k.shape[2]
    qg = q.reshape(b, s, g, h // g, d)
    scores = torch.einsum("bsgqd,btgd->bgqst", qg, k).float() * (d ** -0.5)
    qp = torch.as_tensor(q_offset, device=q.device).reshape(-1, 1) \
        + torch.arange(s, device=q.device)                       # [b or 1, s]
    kp = torch.arange(t, device=q.device)
    valid = torch.ones((qp.shape[0], s, t), dtype=torch.bool, device=q.device)
    if causal:
        valid = valid & (kp[None, None, :] <= qp[:, :, None])
    if sliding_window:
        in_window = kp[None, None, :] > qp[:, :, None] - sliding_window
        if prefix_len:
            in_window = in_window | (kp[None, None, :] < prefix_len)
        valid = valid & in_window
    if kv_len is not None:
        kv_len = torch.as_tensor(kv_len, device=q.device).reshape(-1, 1, 1)
        valid = valid & (kp[None, None, :] < kv_len)
    scores = scores.masked_fill(~valid[:, None, None], float("-inf"))
    w = torch.softmax(scores, dim=-1)
    w = torch.nan_to_num(w, nan=0.0).to(v.dtype)  # fully masked rows
    out = torch.einsum("bgqst,btgd->bsgqd", w, v).reshape(b, s, h, d)
    if return_lse:
        return out, torch.logsumexp(scores, dim=-1).reshape(b, h, s)
    return out
