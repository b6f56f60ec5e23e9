"""Decoder-only LM, dense path — the port of
``src/repro/models/transformer.py``.

Covered: ``DecodeState`` (paged KV), ``init_params``, ``prefill`` with the
paged branch of ``_caches_to_state``, ``decode_step`` and
``decode_step_layerwise``.  Layers are a Python loop over params stacked
``[L, ...]`` (the reference's ``lax.scan`` has no counterpart to gain
here: PyTorch runs eagerly).  Prefill attention always goes through the
flash_prefill kernel, decode attention through the paged_attention
kernel.  MoE, sliding-window ring KV, SSM/hybrid, VLM and meta tokens
raise ``NotImplementedError``: they are later slices (ROADMAP.md, queue 1
item 8).

Decode steps update the state's KV pages IN PLACE (the new token is
written into the current page of every layer) and return a state that
shares those pages; the reference returns fresh arrays instead.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.device import resolve_device
from repro_torch.models.attention import KVPages, paged_decode_with_write, rope
from repro_torch.models.config import ModelConfig
from repro_torch.models.flash import flash_attention
from repro_torch.models.layers import PARAM_DTYPE, dense, normal_, rmsnorm, swiglu

__all__ = ["DecoderLM", "DecodeState"]


@dataclasses.dataclass
class DecodeState:
    context_lens: torch.Tensor                 # [b] int32 tokens present
    k_pages: torch.Tensor | None = None        # [L, b, per_seq, bs, g, hd]
    v_pages: torch.Tensor | None = None
    block_tables: torch.Tensor | None = None   # [b, per_seq] int32 within-seq ids


def _unsupported(cfg: ModelConfig) -> str | None:
    if cfg.is_encoder_decoder:
        return "encoder-decoder (EncDecLM)"
    if cfg.family not in ("dense",):
        return f"family {cfg.family!r}"
    if cfg.sliding_window:
        return "sliding-window ring KV"
    if cfg.num_meta_tokens:
        return "meta tokens"
    if not cfg.has_attention:
        return "attention-free"
    return None


def _layer(tree, i: int):
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


class DecoderLM:
    BLOCK_SIZE = 32

    def __init__(self, cfg: ModelConfig, *, device: str | torch.device = "cuda"):
        missing = _unsupported(cfg)
        if missing is not None:
            raise NotImplementedError(
                f"{cfg.name}: {missing} is not ported yet — the port covers the "
                "dense decoder (see ROADMAP.md, queue 1 item 8)")
        self.cfg = cfg
        self.device = resolve_device(device)

    # ------------------------------------------------------------- init
    def init_params(self, seed: int = 0, device: str | torch.device | None = None) -> dict:
        """Random weights from a seeded ``torch.Generator`` on ``device``
        (default: the model's), with the reference's layout, scales and
        dtype (bf16).  The numbers differ from the JAX init's: the tests
        carry JAX weights over with ``bridge.params_from_jax`` instead."""
        cfg = self.cfg
        dev = self.device if device is None else resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(seed)
        L, d, ff = cfg.num_layers, cfg.d_model, cfg.d_ff

        def empty(*shape):
            return torch.empty(shape, dtype=PARAM_DTYPE, device=dev)

        def ones(*shape):
            return torch.ones(shape, dtype=PARAM_DTYPE, device=dev)

        def stacked_dense(d_in, d_out):
            w = empty(L, d_in, d_out)
            for layer in range(L):  # one layer's f32 draw at a time
                normal_(w[layer], gen, d_in ** -0.5)
            return {"w": w}

        layers = {
            "attn_norm": {"scale": ones(L, d)},
            "attn": {
                "q": stacked_dense(d, cfg.attn_dim),
                "k": stacked_dense(d, cfg.kv_dim),
                "v": stacked_dense(d, cfg.kv_dim),
                "o": stacked_dense(cfg.attn_dim, d),
            },
            "mlp_norm": {"scale": ones(L, d)},
        }
        if cfg.mlp_type == "swiglu":
            layers["mlp"] = {"gate": stacked_dense(d, ff), "up": stacked_dense(d, ff),
                             "down": stacked_dense(ff, d)}
        else:
            layers["mlp"] = {"up": stacked_dense(d, ff), "down": stacked_dense(ff, d)}
        params = {
            "embed": {"table": normal_(empty(cfg.padded_vocab, d), gen, 0.02)},
            "layers": layers,
            "final_norm": {"scale": ones(d)},
        }
        if not cfg.tie_embeddings:
            params["lm_head"] = {"table": normal_(empty(cfg.padded_vocab, d), gen, 0.02)}
        return params

    def _apply_mlp(self, p, x):
        if self.cfg.mlp_type == "swiglu":
            return swiglu(p["mlp"], x)
        up = dense(p["mlp"]["up"], x)
        return dense(p["mlp"]["down"], torch.nn.functional.gelu(up, approximate="tanh"))

    def _logits(self, params, x):
        table = params.get("lm_head", params["embed"])["table"]
        return x @ table.T.to(x.dtype)

    def _tokens(self, tokens) -> torch.Tensor:
        return torch.as_tensor(tokens, device=self.device).long()

    # ------------------------------------------------- full-seq forward
    def _sub_full(self, p, x, positions):
        cfg = self.cfg
        h = rmsnorm(p["attn_norm"], x, cfg.norm_eps)
        b, s, _ = h.shape
        q = dense(p["attn"]["q"], h).reshape(b, s, cfg.num_heads, cfg.head_dim)
        k = dense(p["attn"]["k"], h).reshape(b, s, cfg.num_kv_heads, cfg.head_dim)
        v = dense(p["attn"]["v"], h).reshape(b, s, cfg.num_kv_heads, cfg.head_dim)
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
        a = flash_attention(q, k, v, causal=True)
        x = x + dense(p["attn"]["o"], a.reshape(b, s, -1))
        x = x + self._apply_mlp(p, rmsnorm(p["mlp_norm"], x, cfg.norm_eps))
        return x, k, v

    # ---------------------------------------------------------- prefill
    def prefill(self, params, batch, *, max_blocks_margin: int = 16, remat: bool = True):
        """Run the prompt, return (last-token logits, DecodeState).
        ``remat`` is accepted for call compatibility; there is no
        backward here to rematerialize for."""
        del remat
        if batch.get("vision_embeds") is not None:
            raise NotImplementedError("VLM vision_embeds are not ported yet (ROADMAP.md)")
        tokens = self._tokens(batch["tokens"])
        b, s = tokens.shape
        x = params["embed"]["table"][tokens]
        positions = torch.arange(s, device=self.device)[None, :].expand(b, s)
        ks, vs = [], []
        for layer in range(self.cfg.num_layers):
            x, k, v = self._sub_full(_layer(params["layers"], layer), x, positions)
            ks.append(k)
            vs.append(v)
        x = rmsnorm(params["final_norm"], x, self.cfg.norm_eps)
        logits = self._logits(params, x[:, -1, :])
        state = self._caches_to_state(torch.stack(ks), torch.stack(vs), b, s,
                                      max_blocks_margin)
        return logits, state

    def _caches_to_state(self, k, v, b, s, margin) -> DecodeState:
        """k, v [L, b, s, g, hd] -> per-sequence pages with ``margin`` empty
        pages after the prompt's, identity block tables."""
        bs = self.BLOCK_SIZE
        L, _, _, g, hd = k.shape
        spb = -(-s // bs)
        per_seq = spb + margin
        k_pages = torch.zeros((L, b, per_seq * bs, g, hd), dtype=k.dtype, device=k.device)
        v_pages = torch.zeros_like(k_pages)
        k_pages[:, :, :s] = k
        v_pages[:, :, :s] = v
        tables = torch.arange(per_seq, dtype=torch.int32, device=k.device)
        return DecodeState(
            context_lens=torch.full((b,), s, dtype=torch.int32, device=k.device),
            k_pages=k_pages.reshape(L, b, per_seq, bs, g, hd),
            v_pages=v_pages.reshape(L, b, per_seq, bs, g, hd),
            block_tables=tables[None, :].repeat(b, 1),
        )

    # ------------------------------------------------------ decode step
    def _sub_decode(self, p, h, state: DecodeState, pages: KVPages):
        cfg = self.cfg
        b, _ = h.shape
        pos = state.context_lens
        hn = rmsnorm(p["attn_norm"], h, cfg.norm_eps)
        q = dense(p["attn"]["q"], hn).reshape(b, 1, cfg.num_heads, cfg.head_dim)
        k = dense(p["attn"]["k"], hn).reshape(b, 1, cfg.num_kv_heads, cfg.head_dim)
        v = dense(p["attn"]["v"], hn).reshape(b, 1, cfg.num_kv_heads, cfg.head_dim)
        q = rope(q, pos[:, None], cfg.rope_theta)[:, 0]
        k = rope(k, pos[:, None], cfg.rope_theta)[:, 0]
        a, pages = paged_decode_with_write(q, k, v[:, 0], pages, state.block_tables,
                                           state.context_lens)
        h = h + dense(p["attn"]["o"], a.reshape(b, -1))
        h = h + self._apply_mlp(p, rmsnorm(p["mlp_norm"], h, cfg.norm_eps))
        return h, pages

    def decode_step(self, params, state: DecodeState, tokens):
        """One token for every sequence.  tokens: [b] -> (logits [b, V],
        new DecodeState sharing ``state``'s pages, updated in place)."""
        x = params["embed"]["table"][self._tokens(tokens)]
        for layer in range(self.cfg.num_layers):
            pages = KVPages(state.k_pages[layer], state.v_pages[layer])
            x, _ = self._sub_decode(_layer(params["layers"], layer), x, state, pages)
        x = rmsnorm(params["final_norm"], x, self.cfg.norm_eps)
        logits = self._logits(params, x)
        return logits, dataclasses.replace(state, context_lens=state.context_lens + 1)

    def decode_step_layerwise(self, params, state: DecodeState, tokens, fetch_layer):
        """One decode step where layer ``l``'s KV pages come from
        ``fetch_layer(l) -> (k_pages_l, v_pages_l)`` (each [b, per_seq, bs,
        g, hd]) right before layer ``l``'s attention — the compute half of
        the layer-streamed pull.  Same per-layer math as ``decode_step``,
        so logits and pages are identical to the full-state step.  The
        returned state stacks the fetched pages (with the new token)."""
        x = params["embed"]["table"][self._tokens(tokens)]
        new_k, new_v = [], []
        for layer in range(self.cfg.num_layers):
            pages = KVPages(*fetch_layer(layer))
            x, pages = self._sub_decode(_layer(params["layers"], layer), x, state, pages)
            new_k.append(pages.k_pages)
            new_v.append(pages.v_pages)
        x = rmsnorm(params["final_norm"], x, self.cfg.norm_eps)
        logits = self._logits(params, x)
        return logits, dataclasses.replace(
            state, k_pages=torch.stack(new_k), v_pages=torch.stack(new_v),
            context_lens=state.context_lens + 1)
