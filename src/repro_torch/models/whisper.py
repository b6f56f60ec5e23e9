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

Under a device mesh (``models.sharding``; params from
``launch.shardings.shard_params``): batch rows over the DP axes, tensor
parallelism over 'model' with the helpers of ``models.transformer``.
q, k and v are column-parallel with their biases sharded (whisper-large-v3's
20 heads: 5 a rank at 4; at 16 the heads do not divide and the columns
are gathered), ``o`` and the MLP's ``down`` row-parallel with their
biases added once, after the sum; LayerNorm and GELU as on one device.
The cross-attention's k and v are computed from the column-sharded
weights and gathered over 'model' into the state (``cross_k``/``cross_v``
are whole on every 'model' rank by the rule); a decode step's
cross-attention reads the rank's heads of them.  The decoder's self-KV
pages split ``per_seq`` over 'model' where it divides
(``transformer.place_pages``), and the decode step's self-attention then
takes the sequence-parallel paged_attention combine with ``lse``.  The
embedding and the tied head are vocab-sharded (51866 padded);
``dec_pos`` is whole in serving.  ``train_loss`` runs the train
placements: FSDP over 'data' (each layer's shards gathered at its use,
inside the decoder's remat regions), the vocab-sharded loss, the mean
over the global batch.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.utils.checkpoint

from repro_torch.device import resolve_device
from repro_torch.models import sharding
from repro_torch.models.attention import KVPages, identity_slice, paged_decode_with_write
from repro_torch.models.config import ModelConfig
from repro_torch.models.flash import flash_attention
from repro_torch.models.layers import (
    PARAM_DTYPE, column_input, dense_init, embed, gelu_mlp, layernorm, normal_, row_dense)
from repro_torch.models.sharding import MeshLayout
from repro_torch.models.transformer import (
    _fsdp_gather, _layers, attend_whole, heads, kv_for, paged_kv, place_pages,
    sharded_nll)

__all__ = ["EncDecLM", "EncDecState"]


@dataclasses.dataclass
class EncDecState:
    context_lens: torch.Tensor   # [b] int32 decoder tokens present
    k_pages: torch.Tensor        # [L, b, per_seq, bs, g, hd] decoder self-KV
    v_pages: torch.Tensor
    block_tables: torch.Tensor   # [b, per_seq] int32 within-seq page ids
    cross_k: torch.Tensor        # [L, b, enc_seq, g, hd]
    cross_v: torch.Tensor
    # under a mesh: how the tensors above are split (None: whole)
    layout: MeshLayout | None = None


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
        self._fsdp_plans: dict = {}   # mesh shape -> fsdp_plan

    # ------------------------------------------------------------- init
    def init_params(self, seed: int = 0, device: str | torch.device | None = None) -> dict:
        """Random weights from a seeded ``torch.Generator`` on ``device``
        (default: the model's), with the reference's keys, layout, scales
        and dtypes (bf16; biases zero, norms one and zero).  The numbers
        differ from the JAX init's: the tests carry JAX weights over with
        ``bridge.params_from_jax``.  ``device="meta"``: the shapes and
        dtypes alone (``param_shapes``), no draw."""
        cfg = self.cfg
        dev = self.device if device is None else resolve_device(device)
        gen = None if dev.type == "meta" else torch.Generator(device=dev).manual_seed(seed)
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

    def param_shapes(self) -> dict:
        """The params as meta tensors: the full shapes and dtypes, no
        storage (the reference's ``jax.eval_shape`` of ``init_params``)."""
        return self.init_params(device="meta")

    def _fsdp_plan(self, shapes=None):
        """Under a mesh, the FSDP gathers of every leaf of the train
        placements (``launch.shardings.fsdp_plan``) from ``shapes`` (None:
        ``param_shapes()``); None without a mesh."""
        mesh = sharding.get_mesh()
        if mesh is None:
            return None
        from repro_torch.launch.shardings import fsdp_plan

        key = tuple(mesh.shape.items())
        if key not in self._fsdp_plans:
            self._fsdp_plans[key] = fsdp_plan(
                self.param_shapes() if shapes is None else shapes, mesh)
        return self._fsdp_plans[key]

    # ------------------------------------------------------------ pieces
    def _proj_qkv(self, p, xq, xkv):
        """q [b, s, h, hd] from xq, k and v [b, t, g, hd] from xkv, through
        the column-parallel weights (the rank's heads under TP, or every
        head where they do not divide)."""
        cfg = self.cfg
        xq_in = column_input(xq, p["q"]["w"], cfg.attn_dim)
        k_in = column_input(xkv, p["k"]["w"], cfg.kv_dim) if xkv is not xq else xq_in
        v_in = k_in
        if k_in.dtype != xkv.dtype:
            # promoted (bf16 frames, f32 weights): each product's copy, so that
            # each one's gradient is rounded to xkv's dtype apart, as on one device
            k_in, v_in = (column_input(xkv, p[n]["w"], cfg.kv_dim) for n in ("k", "v"))
        q = heads(p["q"], xq_in, cfg.num_heads, cfg.head_dim)
        k = heads(p["k"], k_in, cfg.num_kv_heads, cfg.head_dim)
        v = heads(p["v"], v_in, cfg.num_kv_heads, cfg.head_dim)
        return q, k, v

    def _attend(self, p, q, k, v, causal: bool):
        """Attention of q's heads over k and v, then the row-parallel ``o``."""
        cfg = self.cfg
        b, s = q.shape[:2]
        kq, vq = kv_for(q, k, v, cfg.num_heads, cfg.num_kv_heads)
        a = flash_attention(q, kq, vq, causal=causal)
        return row_dense(p["o"], a.reshape(b, s, -1), cfg.attn_dim)

    def _mlp(self, p, x):
        return gelu_mlp(p, x, self.cfg.d_ff)

    def _whole_groups(self, kv):
        if kv.shape[2] < self.cfg.num_kv_heads:
            return sharding.all_gather(kv, "model", 2)
        return kv

    def _enc_layer(self, p, x, plan=None):
        if plan is not None:
            p = _fsdp_gather(p, plan, shift=1)
        cfg = self.cfg
        hn = layernorm(p["attn_norm"], x, cfg.norm_eps)
        q, k, v = self._proj_qkv(p["attn"], hn, hn)
        x = x + self._attend(p["attn"], q, k, v, causal=False)
        return x + self._mlp(p["mlp"], layernorm(p["mlp_norm"], x, cfg.norm_eps))

    def encode(self, params, frames, *, plan=None):
        """frames: [b, enc_seq, d] precomputed embeddings (stub frontend)
        -> the encoder's output [b, enc_seq, d]."""
        cfg = self.cfg
        frames = torch.as_tensor(frames, device=self.device)
        x = frames.to(PARAM_DTYPE) \
            + _sinusoid(frames.shape[1], cfg.d_model, self.device).to(PARAM_DTYPE)
        for p in _layers(params["enc_layers"], cfg.encoder_layers):
            x = self._enc_layer(p, x, None if plan is None else plan["enc_layers"])
        final = params["enc_final_norm"]
        if plan is not None:
            final = _fsdp_gather(final, plan["enc_final_norm"])
        return layernorm(final, x, cfg.norm_eps)

    def _decoder_layer(self, p, x, enc_out, plan=None, return_kv=True):
        """One decoder layer over the prompt -> (x, (k, v, cross k, cross v)
        when ``return_kv``, the cross KV whole over 'model')."""
        if plan is not None:
            p = _fsdp_gather(p, plan, shift=1)
        cfg = self.cfg
        hn = layernorm(p["self_norm"], x, cfg.norm_eps)
        q, k, v = self._proj_qkv(p["self_attn"], hn, hn)
        x = x + self._attend(p["self_attn"], q, k, v, causal=True)
        hn = layernorm(p["cross_norm"], x, cfg.norm_eps)
        cq, ck, cv = self._proj_qkv(p["cross_attn"], hn, enc_out)
        x = x + self._attend(p["cross_attn"], cq, ck, cv, causal=False)
        x = x + self._mlp(p["mlp"], layernorm(p["mlp_norm"], x, cfg.norm_eps))
        if not return_kv:
            return x, ()
        return x, (k, v, self._whole_groups(ck), self._whole_groups(cv))

    def _decoder(self, params, tokens, enc_out, *, return_kv: bool = True,
                 remat: bool = False, plan=None):
        """The decoder's prompt pass -> (normed hidden states, per-layer
        self-KV and cross-KV stacked [L, b, ...], or {} without
        ``return_kv``).  ``remat`` checkpoints each layer."""
        cfg = self.cfg
        b, s = tokens.shape
        top = (lambda name: params[name]) if plan is None else \
            (lambda name: _fsdp_gather(params[name], plan[name]))
        x = embed(top("embed"), tokens, cfg.padded_vocab) + top("dec_pos")[:s][None]
        caches = {"k": [], "v": [], "ck": [], "cv": []}
        layer_plan = None if plan is None else plan["dec_layers"]
        for p in _layers(params["dec_layers"], cfg.num_layers):
            if remat:
                x, kv = torch.utils.checkpoint.checkpoint(
                    self._decoder_layer, p, x, enc_out, layer_plan, return_kv,
                    use_reentrant=False)
            else:
                x, kv = self._decoder_layer(p, x, enc_out, layer_plan, return_kv)
            if return_kv:
                for key, val in zip(caches, kv):
                    caches[key].append(val)
        x = layernorm(top("dec_final_norm"), x, cfg.norm_eps)
        if not return_kv:
            return x, {}
        return x, {key: torch.stack(vals) for key, vals in caches.items()}

    def _logits(self, params, x):
        """x @ table.T: this rank's vocab columns when the tied table is
        vocab-sharded."""
        table = params["embed"]["table"]
        x = column_input(x, table.T, self.cfg.padded_vocab)
        return x @ table.T.to(x.dtype)

    # ------------------------------------------------------------- train
    def train_loss(self, params, batch, *, remat: bool = True, batch_axes: tuple[str, ...] = ()):
        """batch: frames [b, enc_seq, d], tokens [b, s] -> (loss, {"nll"}):
        the decoder's mean next-token cross-entropy.  Under a mesh, as
        ``DecoderLM.train_loss``: this rank's train shards and batch rows
        (split over ``batch_axes``), the mean over the global batch."""
        cfg = self.cfg
        plan = self._fsdp_plan()
        enc_out = self.encode(params, batch["frames"], plan=plan)
        tokens = torch.as_tensor(batch["tokens"], device=self.device).long()
        x, _ = self._decoder(params, tokens, enc_out, return_kv=False, remat=remat, plan=plan)
        table = params["embed"] if plan is None else _fsdp_gather(params["embed"], plan["embed"])
        logits = self._logits({"embed": table}, x[:, :-1]).float()
        nll = sharded_nll(logits, tokens[:, 1:], cfg.vocab_size, cfg.padded_vocab)
        split = sharding.axis_size(batch_axes)
        if split == 1:
            nll = nll.mean()
        else:
            nll = sharding.all_reduce(nll.sum(), batch_axes) / (nll.numel() * split)
        rest = tuple(a for a in sharding.dp_axes() if a not in batch_axes)
        return sharding.share_grad(nll, rest), {"nll": nll}

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

    # ----------------------------------------------------------- prefill
    def prefill(self, params, batch, *, max_blocks_margin: int = 16, remat: bool = True,
                batch_axes: tuple[str, ...] = ()):
        """Encode ``batch["frames"]`` and run the decoder prompt
        ``batch["tokens"]`` -> (last-token logits, EncDecState).  ``remat``
        is accepted for call compatibility.  Under a mesh the batch holds
        this rank's rows, split over ``batch_axes``."""
        del remat
        cfg = self.cfg
        enc_out = self.encode(params, batch["frames"])
        tokens = torch.as_tensor(batch["tokens"], device=self.device).long()
        b, s = tokens.shape
        x, caches = self._decoder(params, tokens, enc_out)
        logits = self._logits(params, x[:, -1])
        k_pages, v_pages, tables = paged_kv(caches["k"], caches["v"], self.BLOCK_SIZE,
                                            max_blocks_margin)
        layout = None
        if sharding.get_mesh() is not None:
            k_pages, v_pages, layout = place_pages(k_pages, v_pages, batch_axes,
                                                   cfg.num_kv_heads)
            pps = k_pages.shape[2]
            tables = (identity_slice(b, pps, self.device) if layout.seq_parallel
                      else tables[:1].repeat(b, 1))
        state = EncDecState(
            context_lens=torch.full((b,), s, dtype=torch.int32, device=self.device),
            k_pages=k_pages, v_pages=v_pages, block_tables=tables,
            cross_k=caches["ck"], cross_v=caches["cv"], layout=layout)
        return logits, state

    # -------------------------------------------------------- decode step
    def decode_step(self, params, state: EncDecState, tokens):
        """One token for every sequence.  tokens: [b] -> (logits [b, V], new
        EncDecState sharing ``state``'s pages, updated in place)."""
        cfg = self.cfg
        tokens = torch.as_tensor(tokens, device=self.device).long()
        b = tokens.shape[0]
        pos = state.context_lens
        seq_parallel = state.layout is not None and state.layout.seq_parallel
        x = embed(params["embed"], tokens, cfg.padded_vocab) + params["dec_pos"][pos.long()]
        for layer, p in enumerate(_layers(params["dec_layers"], cfg.num_layers)):
            hn = layernorm(p["self_norm"], x, cfg.norm_eps)[:, None, :]
            q, k, v = self._proj_qkv(p["self_attn"], hn, hn)
            pages = KVPages(state.k_pages[layer], state.v_pages[layer])
            a, _ = attend_whole(q[:, 0], k[:, 0], v[:, 0], cfg.num_heads, cfg.num_kv_heads,
                                lambda q, k, v: paged_decode_with_write(
                                    q, k, v, pages, state.block_tables, pos,
                                    seq_parallel=seq_parallel))
            x = x + row_dense(p["self_attn"]["o"], a.reshape(b, -1), cfg.attn_dim)
            hn = layernorm(p["cross_norm"], x, cfg.norm_eps)
            cp = p["cross_attn"]
            cq = heads(cp["q"], column_input(hn, cp["q"]["w"], cfg.attn_dim), cfg.num_heads,
                       cfg.head_dim)[:, None]
            x = x + self._attend(cp, cq, state.cross_k[layer], state.cross_v[layer],
                                 causal=False)[:, 0]
            x = x + self._mlp(p["mlp"], layernorm(p["mlp_norm"], x, cfg.norm_eps))
        x = layernorm(params["dec_final_norm"], x, cfg.norm_eps)
        logits = self._logits(params, x)
        return logits, dataclasses.replace(state, context_lens=state.context_lens + 1)
