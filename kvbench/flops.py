"""Model FLOPs of the served work, from a configuration's ``run`` block
(the arithmetic behind the MFU metrics: 2 operations a multiply-add).

The formulas here hold for a stack of one kind of layer: attention and a
SwiGLU or routed experts in every layer.  A configuration's reference
module may define ``prefill_flops(m, prompt)`` and
``decode_token_flops(m, keys)`` beside its equations; the readers take
those for its cells (``for_run``)."""
from __future__ import annotations

__all__ = ["layer_params", "prefill_flops", "decode_token_flops", "for_run"]


def layer_params(m: dict) -> int:
    """Weights one token multiplies through in all layers: q, k, v, o and
    the SwiGLU MLP, or the router and the ``experts_per_token`` routed
    experts' SwiGLUs."""
    d, hd = m["d_model"], m["head_dim"]
    attn = d * m["num_heads"] * hd * 2 + 2 * d * m["num_kv_heads"] * hd
    if m["num_experts"]:
        ffn = d * m["num_experts"] + m["experts_per_token"] * 3 * d * m["d_ff"]
    else:
        ffn = 3 * d * m["d_ff"]
    return m["num_layers"] * (attn + ffn)


def _attention(m: dict, pairs: int) -> int:
    """q.k and p.v over ``pairs`` (query, key) pairs, every layer and head."""
    return m["num_layers"] * 4 * m["num_heads"] * m["head_dim"] * pairs


def prefill_flops(m: dict, prompt: int) -> int:
    """A prompt of ``prompt`` tokens: every token through the layers, causal
    attention, and the logits of the last token (the first served)."""
    return (2 * prompt * layer_params(m) + 2 * m["d_model"] * m["vocab_size"]
            + _attention(m, prompt * (prompt + 1) // 2))


def decode_token_flops(m: dict, keys: int) -> int:
    """One decode token attending over ``keys`` cached keys (its own
    included), with its logits."""
    return (2 * (layer_params(m) + m["d_model"] * m["vocab_size"])
            + _attention(m, keys))


def for_run(run) -> tuple:
    """``(prefill_flops, decode_token_flops)`` of the run's configuration:
    each its reference module's (``run.reference``) where it defines one,
    else this module's."""
    return (getattr(run.reference, "prefill_flops", prefill_flops),
            getattr(run.reference, "decode_token_flops", decode_token_flops))
