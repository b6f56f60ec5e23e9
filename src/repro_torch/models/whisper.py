"""Whisper-style encoder-decoder backbone (audio frontend stubbed) — the
port of ``src/repro/models/whisper.py``.

The conv/mel frontend is a stub: the caller hands precomputed frame
embeddings ``[b, enc_seq, d]``.  The encoder is a non-causal transformer
over the frames (sinusoidal positions); the decoder a causal one with
learned positions and cross-attention over the encoder's output.
LayerNorm, GELU (tanh form) and biases throughout; logits are tied to
the embedding table.

Prefill = encode + the decoder's prompt pass.  The transferable state is
the decoder's self-KV in pages plus the cross-attention KV of the
encoder's output (``EncDecState``).  Every attention runs through the
flash_prefill kernel — the encoder's self-attention and every
cross-attention with ``causal=False``, the decoder prompt's
self-attention causal — except the decode step's self-attention, which
is paged_attention over the pages (the new token written in place, as
in ``DecoderLM``).

Training: ``train_loss`` is the decoder's next-token cross-entropy over
the encoded frames; ``remat`` checkpoints each decoder layer (the
reference's ``jax.checkpoint`` covers the decoder's scan body, not the
encoder's).  ``decode_state_shape`` gives the decode state as meta
tensors.

The reference casts the frames to bf16 whatever the weights' dtype, and
lets a matmul of bf16 activations with f32 weights promote to f32; so
does this port's ``layers.dense``, so that f32 weights give the
reference's numbers.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.utils.checkpoint

from repro_torch.device import resolve_device
from repro_torch.models import sharding
from repro_torch.models.attention import KVPages, paged_decode_with_write
from repro_torch.models.config import ModelConfig
from repro_torch.models.flash import flash_attention
from repro_torch.models.layers import (
    PARAM_DTYPE, dense, dense_init, gelu_mlp, layernorm, normal_)
from repro_torch.models.transformer import _layer, paged_kv, sharded_nll

__all__ = ["EncDecLM", "EncDecState"]


@dataclasses.dataclass
class EncDecState:
    context_lens: torch.Tensor   # [b] int32 decoder tokens present
    k_pages: torch.Tensor        # [L, b, per_seq, bs, g, hd] decoder self-KV
    v_pages: torch.Tensor
    block_tables: torch.Tensor   # [b, per_seq] int32 within-seq page ids
    cross_k: torch.Tensor        # [L, b, enc_seq, g, hd]
    cross_v: torch.Tensor


def _sinusoid(seq: int, dim: int, device) -> torch.Tensor:
    pos = torch.arange(seq, device=device, dtype=torch.float32)[:, None]
    i = torch.arange(dim // 2, device=device, dtype=torch.float32)[None, :]
    angles = pos / torch.pow(10000.0, 2 * i / dim)
    return torch.cat([torch.sin(angles), torch.cos(angles)], dim=-1)


class EncDecLM:
    BLOCK_SIZE = 32

    def __init__(self, cfg: ModelConfig, *, device: str | torch.device = "cuda"):
        if not cfg.is_encoder_decoder:
            raise ValueError("EncDecLM requires an encoder-decoder config")
        self.cfg = cfg
        self.device = resolve_device(device)

    # ------------------------------------------------------------- init
    def init_params(self, seed: int = 0, device: str | torch.device | None = None) -> dict:
        """Random weights from a seeded ``torch.Generator`` on ``device``
        (default: the model's), with the reference's keys, layout, scales
        and dtypes (bf16; biases zero, norms one and zero).  The numbers
        differ from the JAX init's: the tests carry JAX weights over with
        ``bridge.params_from_jax``."""
        cfg = self.cfg
        dev = self.device if device is None else resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(seed)
        d, ff = cfg.d_model, cfg.d_ff

        def norm(n):
            return {"scale": torch.ones((n, d), dtype=PARAM_DTYPE, device=dev),
                    "bias": torch.zeros((n, d), dtype=PARAM_DTYPE, device=dev)}

        def lin(n, d_in, d_out):
            return dense_init(gen, d_in, d_out, lead=(n,), bias=True, device=dev)

        def attn(n):
            return {"q": lin(n, d, cfg.attn_dim), "k": lin(n, d, cfg.kv_dim),
                    "v": lin(n, d, cfg.kv_dim), "o": lin(n, cfg.attn_dim, d)}

        def mlp(n):
            return {"up": lin(n, d, ff), "down": lin(n, ff, d)}

        ne, nd = cfg.encoder_layers, cfg.num_layers
        enc = {"attn_norm": norm(ne), "attn": attn(ne), "mlp_norm": norm(ne), "mlp": mlp(ne)}
        dec = {"self_norm": norm(nd), "self_attn": attn(nd), "cross_norm": norm(nd),
               "cross_attn": attn(nd), "mlp_norm": norm(nd), "mlp": mlp(nd)}

        def table(rows):
            return normal_(torch.empty((rows, d), dtype=PARAM_DTYPE, device=dev), gen, 0.02)

        final = {"scale": torch.ones(d, dtype=PARAM_DTYPE, device=dev),
                 "bias": torch.zeros(d, dtype=PARAM_DTYPE, device=dev)}
        return {
            "enc_layers": enc,
            "dec_layers": dec,
            "embed": {"table": table(cfg.padded_vocab)},
            "dec_pos": table(cfg.max_positions),
            "enc_final_norm": final,
            "dec_final_norm": {k: v.clone() for k, v in final.items()},
        }

    # ------------------------------------------------------------ pieces
    def _proj_qkv(self, p, xq, xkv):
        cfg = self.cfg
        b, s = xq.shape[:2]
        t = xkv.shape[1]
        q = dense(p["q"], xq).reshape(b, s, cfg.num_heads, cfg.head_dim)
        k = dense(p["k"], xkv).reshape(b, t, cfg.num_kv_heads, cfg.head_dim)
        v = dense(p["v"], xkv).reshape(b, t, cfg.num_kv_heads, cfg.head_dim)
        return q, k, v

    def encode(self, params, frames):
        """frames: [b, enc_seq, d] precomputed embeddings (stub frontend)
        -> the encoder's output [b, enc_seq, d]."""
        cfg = self.cfg
        frames = torch.as_tensor(frames, device=self.device)
        x = frames.to(PARAM_DTYPE) \
            + _sinusoid(frames.shape[1], cfg.d_model, self.device).to(PARAM_DTYPE)
        b, t, _ = x.shape
        for layer in range(cfg.encoder_layers):
            p = _layer(params["enc_layers"], layer)
            hn = layernorm(p["attn_norm"], x, cfg.norm_eps)
            q, k, v = self._proj_qkv(p["attn"], hn, hn)
            a = flash_attention(q, k, v, causal=False)
            x = x + dense(p["attn"]["o"], a.reshape(b, t, -1))
            x = x + gelu_mlp(p["mlp"], layernorm(p["mlp_norm"], x, cfg.norm_eps))
        return layernorm(params["enc_final_norm"], x, cfg.norm_eps)

    def _decoder_layer(self, p, x, enc_out):
        """One decoder layer over the prompt -> (x, (k, v, cross k, cross v))."""
        cfg = self.cfg
        b, s = x.shape[:2]
        hn = layernorm(p["self_norm"], x, cfg.norm_eps)
        q, k, v = self._proj_qkv(p["self_attn"], hn, hn)
        a = flash_attention(q, k, v, causal=True)
        x = x + dense(p["self_attn"]["o"], a.reshape(b, s, -1))
        hn = layernorm(p["cross_norm"], x, cfg.norm_eps)
        cq, ck, cv = self._proj_qkv(p["cross_attn"], hn, enc_out)
        ca = flash_attention(cq, ck, cv, causal=False)
        x = x + dense(p["cross_attn"]["o"], ca.reshape(b, s, -1))
        x = x + gelu_mlp(p["mlp"], layernorm(p["mlp_norm"], x, cfg.norm_eps))
        return x, (k, v, ck, cv)

    def _decoder(self, params, tokens, enc_out, *, return_kv: bool = True,
                 remat: bool = False):
        """The decoder's prompt pass -> (normed hidden states, per-layer
        self-KV and cross-KV stacked [L, b, ...], or {} without
        ``return_kv``).  ``remat`` checkpoints each layer."""
        cfg = self.cfg
        b, s = tokens.shape
        x = params["embed"]["table"][tokens] + params["dec_pos"][:s][None]
        caches = {"k": [], "v": [], "ck": [], "cv": []}
        for layer in range(cfg.num_layers):
            p = _layer(params["dec_layers"], layer)
            if remat:
                x, kv = torch.utils.checkpoint.checkpoint(
                    self._decoder_layer, p, x, enc_out, use_reentrant=False)
            else:
                x, kv = self._decoder_layer(p, x, enc_out)
            if return_kv:
                for key, val in zip(caches, kv):
                    caches[key].append(val)
        x = layernorm(params["dec_final_norm"], x, cfg.norm_eps)
        if not return_kv:
            return x, {}
        return x, {key: torch.stack(vals) for key, vals in caches.items()}

    def _logits(self, params, x):
        return x @ params["embed"]["table"].T.to(x.dtype)

    # ------------------------------------------------------------- train
    def train_loss(self, params, batch, *, remat: bool = True, batch_axes: tuple[str, ...] = ()):
        """batch: frames [b, enc_seq, d], tokens [b, s] -> (loss, {"nll"}):
        the decoder's mean next-token cross-entropy.  ``batch_axes`` is
        accepted for call compatibility (no mesh trains an encoder-decoder
        yet)."""
        del batch_axes
        cfg = self.cfg
        self._check_mesh()
        enc_out = self.encode(params, batch["frames"])
        tokens = torch.as_tensor(batch["tokens"], device=self.device).long()
        x, _ = self._decoder(params, tokens, enc_out, return_kv=False, remat=remat)
        logits = self._logits(params, x[:, :-1]).float()
        nll = sharded_nll(logits, tokens[:, 1:], cfg.vocab_size).mean()
        return nll, {"nll": nll}

    def decode_state_shape(self, batch: int, context_len: int, *, margin: int = 16,
                           dtype: torch.dtype = torch.bfloat16) -> EncDecState:
        """A decode state holding ``context_len`` decoder tokens as meta
        tensors (shapes and dtypes, no storage)."""
        cfg = self.cfg
        L, g, hd, bs = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim, self.BLOCK_SIZE
        per_seq = -(-context_len // bs) + margin

        def meta(shape, dt=dtype):
            return torch.empty(shape, dtype=dt, device="meta")

        return EncDecState(
            context_lens=meta((batch,), torch.int32),
            k_pages=meta((L, batch, per_seq, bs, g, hd)),
            v_pages=meta((L, batch, per_seq, bs, g, hd)),
            block_tables=meta((batch, per_seq), torch.int32),
            cross_k=meta((L, batch, cfg.encoder_seq, g, hd)),
            cross_v=meta((L, batch, cfg.encoder_seq, g, hd)),
        )

    def _check_mesh(self):
        if sharding.get_mesh() is not None:
            raise NotImplementedError(f"{self.cfg.name}: the encoder-decoder under a mesh "
                                      f"(ROADMAP.md, queue 1, item 3)")

    # ----------------------------------------------------------- prefill
    def prefill(self, params, batch, *, max_blocks_margin: int = 16, remat: bool = True,
                batch_axes: tuple[str, ...] = ()):
        """Encode ``batch["frames"]`` and run the decoder prompt
        ``batch["tokens"]`` -> (last-token logits, EncDecState).  ``remat``
        and ``batch_axes`` are accepted for call compatibility (no mesh
        runs an encoder-decoder yet)."""
        del remat, batch_axes
        self._check_mesh()
        enc_out = self.encode(params, batch["frames"])
        tokens = torch.as_tensor(batch["tokens"], device=self.device).long()
        b, s = tokens.shape
        x, caches = self._decoder(params, tokens, enc_out)
        logits = self._logits(params, x[:, -1])
        k_pages, v_pages, tables = paged_kv(caches["k"], caches["v"], self.BLOCK_SIZE,
                                            max_blocks_margin)
        state = EncDecState(
            context_lens=torch.full((b,), s, dtype=torch.int32, device=self.device),
            k_pages=k_pages, v_pages=v_pages, block_tables=tables,
            cross_k=caches["ck"], cross_v=caches["cv"])
        return logits, state

    # -------------------------------------------------------- decode step
    def decode_step(self, params, state: EncDecState, tokens):
        """One token for every sequence.  tokens: [b] -> (logits [b, V], new
        EncDecState sharing ``state``'s pages, updated in place)."""
        cfg = self.cfg
        self._check_mesh()
        tokens = torch.as_tensor(tokens, device=self.device).long()
        b = tokens.shape[0]
        pos = state.context_lens
        x = params["embed"]["table"][tokens] + params["dec_pos"][pos.long()]
        for layer in range(cfg.num_layers):
            p = _layer(params["dec_layers"], layer)
            hn = layernorm(p["self_norm"], x, cfg.norm_eps)[:, None, :]
            q, k, v = self._proj_qkv(p["self_attn"], hn, hn)
            pages = KVPages(state.k_pages[layer], state.v_pages[layer])
            a, _ = paged_decode_with_write(q[:, 0], k[:, 0], v[:, 0], pages,
                                           state.block_tables, pos)
            x = x + dense(p["self_attn"]["o"], a.reshape(b, -1))
            hn = layernorm(p["cross_norm"], x, cfg.norm_eps)
            cq = dense(p["cross_attn"]["q"], hn).reshape(b, 1, cfg.num_heads, cfg.head_dim)
            ca = flash_attention(cq, state.cross_k[layer], state.cross_v[layer], causal=False)
            x = x + dense(p["cross_attn"]["o"], ca.reshape(b, -1))
            x = x + gelu_mlp(p["mlp"], layernorm(p["mlp_norm"], x, cfg.norm_eps))
        x = layernorm(params["dec_final_norm"], x, cfg.norm_eps)
        logits = self._logits(params, x)
        return logits, dataclasses.replace(state, context_lens=state.context_lens + 1)
