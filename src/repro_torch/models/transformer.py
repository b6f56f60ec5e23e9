"""Decoder-only LM for the dense, MoE, VLM, SSM and hybrid families — the
port of ``src/repro/models/transformer.py``.

Covered: ``DecodeState`` (paged KV, sliding-window ring KV, meta-token KV,
SSM state), ``init_params``, ``train_loss`` (next-token cross-entropy on
the text positions, plus 0.01 × the MoE load-balance loss; ``remat``
checkpoints each layer group with ``torch.utils.checkpoint``, after the
reference's ``jax.checkpoint(..., nothing_saveable)`` over its scan
body), ``prefill`` (with the meta-token prefix and the VLM's early-fused
``vision_embeds``), ``decode_step``, ``decode_step_layerwise`` (paged
archs only, as in the reference) and ``decode_state_shape`` (meta
tensors).  The
params keep the reference's layout: ``layers`` stacked over
``n_steps = L / group``, where a group is ``moe_every`` layers for
interleaved MoE (MoE the last of each group, the others dense with
``d_ff_dense``) and holds ``sub{i}`` dicts when it has more than one
layer.  Layers are a Python loop over that stack (the reference's
``lax.scan`` has no counterpart to gain here: PyTorch runs eagerly).
Prefill attention always goes through the flash_prefill kernel (with the
sliding window and the always-visible meta prefix), decode attention over
pages through the paged_attention kernel, the SSD scan of prefill through
the ssd_scan kernel.  Ring-buffer decode attention and the MoE dispatch
are plain torch: the reference has no kernel for either.
Encoder-decoder configs take ``models.whisper.EncDecLM``.

Decode steps update the state's KV pages and ring buffers IN PLACE (the
new token is written into the current page or ring slot of every layer)
and return a state that shares them; the reference returns fresh arrays
instead.  SSM states are replaced, not updated.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.utils.checkpoint

from repro_torch.device import resolve_device
from repro_torch.models.attention import KVPages, paged_decode_with_write, rope
from repro_torch.models.config import ModelConfig
from repro_torch.models.flash import flash_attention
from repro_torch.models.layers import (
    PARAM_DTYPE, dense, dense_init, gelu_mlp, normal_, rmsnorm, swiglu)
from repro_torch.models.moe import moe_apply, moe_init
from repro_torch.models.ssm import ssm_prefill, ssm_state_shapes, ssm_step

__all__ = ["DecoderLM", "DecodeState", "paged_kv", "sharded_nll", "stack_states"]


@dataclasses.dataclass
class DecodeState:
    context_lens: torch.Tensor                 # [b] int32 tokens present (incl. meta)
    # paged attention KV (dense)
    k_pages: torch.Tensor | None = None        # [L, b, per_seq, bs, g, hd]
    v_pages: torch.Tensor | None = None
    block_tables: torch.Tensor | None = None   # [b, per_seq] int32 within-seq ids
    # ring buffer KV (sliding-window archs)
    ring_k: torch.Tensor | None = None         # [L, b, cap, g, hd]
    ring_v: torch.Tensor | None = None
    ring_pos: torch.Tensor | None = None       # [b, cap] int32 absolute positions (-1 empty)
    # meta-token KV (hymba; always visible)
    meta_k: torch.Tensor | None = None         # [L, b, m, g, hd]
    meta_v: torch.Tensor | None = None
    # SSM state
    ssd_state: torch.Tensor | None = None      # [L, b, nh, hd, ns] f32
    conv_state: torch.Tensor | None = None     # [L, b, k-1, c]


def stack_states(states) -> DecodeState:
    """DecodeStates of single sequences -> one state at b = len(states),
    in new tensors.  For ring, meta and SSM states only: their shapes do
    not depend on the prompt's length (paged KV would need a common
    per-sequence block count)."""
    out = {}
    for f in dataclasses.fields(DecodeState):
        vals = [getattr(st, f.name) for st in states]
        if vals[0] is None:
            out[f.name] = None
        elif f.name in ("context_lens", "block_tables", "ring_pos"):
            out[f.name] = torch.cat(vals)
        else:  # [L, b, ...]
            out[f.name] = torch.cat(vals, dim=1)
    return DecodeState(**out)


def paged_kv(k: torch.Tensor, v: torch.Tensor, block_size: int, margin: int):
    """A prompt's KV [L, b, s, g, hd] -> (k_pages, v_pages [L, b, per_seq,
    block_size, g, hd], block_tables [b, per_seq] int32): the prompt's
    pages, then ``margin`` empty ones, with identity tables."""
    L, b, s, g, hd = k.shape
    per_seq = -(-s // block_size) + margin
    k_pages = torch.zeros((L, b, per_seq * block_size, g, hd), dtype=k.dtype, device=k.device)
    v_pages = torch.zeros_like(k_pages)
    k_pages[:, :, :s] = k
    v_pages[:, :, :s] = v
    tables = torch.arange(per_seq, dtype=torch.int32, device=k.device)
    return (k_pages.reshape(L, b, per_seq, block_size, g, hd),
            v_pages.reshape(L, b, per_seq, block_size, g, hd), tables[None, :].repeat(b, 1))


def sharded_nll(logits: torch.Tensor, labels: torch.Tensor, vocab_size: int) -> torch.Tensor:
    """Per-position cross-entropy over the real vocabulary (the padded
    logits masked to -inf): logsumexp − the label's logit, the value of the
    reference's ``_sharded_nll`` (one device: no vocab axis to keep
    sharded, so the label's logit is a gather)."""
    valid = torch.arange(logits.shape[-1], device=logits.device) < vocab_size
    lse = torch.logsumexp(logits.masked_fill(~valid, float("-inf")), dim=-1)
    return lse - torch.gather(logits, -1, labels[..., None].long())[..., 0]


def _layer(tree, i: int):
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


class DecoderLM:
    BLOCK_SIZE = 32

    def __init__(self, cfg: ModelConfig, *, device: str | torch.device = "cuda"):
        if cfg.is_encoder_decoder:
            raise ValueError("use EncDecLM for encoder-decoder configs")
        self.cfg = cfg
        # scan unit: a group of `moe_every` layers for interleaved MoE
        self.group = cfg.moe_every if (cfg.family == "moe" and cfg.moe_every > 1) else 1
        if cfg.num_layers % self.group:
            raise ValueError("num_layers must divide by moe_every")
        self.n_steps = cfg.num_layers // self.group
        self.device = resolve_device(device)

    def _sub_kind(self, i: int) -> str:
        """FFN kind of sub-layer i within a group: MoE is the LAST of each
        group (Llama-4 places MoE on every `moe_every`-th layer)."""
        if self.cfg.family != "moe":
            return {"dense": "mlp", "vlm": "mlp", "hybrid": "mlp", "ssm": "none"}[
                self.cfg.family]
        return "moe" if i == self.group - 1 else "mlp"

    def _sublayers(self, params):
        """(layer index, that layer's params, its FFN kind) in depth order."""
        for step in range(self.n_steps):
            p = _layer(params["layers"], step)
            for i in range(self.group):
                yield (step * self.group + i, p if self.group == 1 else p[f"sub{i}"],
                       self._sub_kind(i))

    # ------------------------------------------------------------- init
    def init_params(self, seed: int = 0, device: str | torch.device | None = None) -> dict:
        """Random weights from a seeded ``torch.Generator`` on ``device``
        (default: the model's), with the reference's keys, layout, scales
        and dtypes (bf16; the SSM's ``a_log``, ``dt_bias`` and ``d_skip``
        in f32).  The numbers differ from the JAX init's: the tests carry
        JAX weights over with ``bridge.params_from_jax`` instead."""
        cfg = self.cfg
        dev = self.device if device is None else resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(seed)
        d = cfg.d_model
        if self.group == 1:
            layers = self._init_sub(gen, dev, self._sub_kind(0))
        else:
            layers = {f"sub{i}": self._init_sub(gen, dev, self._sub_kind(i))
                      for i in range(self.group)}
        params = {
            "embed": {"table": normal_(torch.empty((cfg.padded_vocab, d), dtype=PARAM_DTYPE,
                                                   device=dev), gen, 0.02)},
            "layers": layers,
            "final_norm": {"scale": torch.ones(d, dtype=PARAM_DTYPE, device=dev)},
        }
        if not cfg.tie_embeddings:
            params["lm_head"] = {"table": normal_(torch.empty_like(params["embed"]["table"]),
                                                  gen, 0.02)}
        if cfg.num_meta_tokens:
            params["meta"] = normal_(torch.empty((cfg.num_meta_tokens, d), dtype=PARAM_DTYPE,
                                                 device=dev), gen, 0.02)
        return params

    def _init_sub(self, gen, dev, ffn_kind: str) -> dict:
        """One sub-layer's params, stacked over the ``n_steps`` groups."""
        cfg = self.cfg
        n, d = self.n_steps, cfg.d_model

        def stacked_dense(d_in, d_out):
            return dense_init(gen, d_in, d_out, lead=(n,), device=dev)

        def norm():
            return {"scale": torch.ones((n, d), dtype=PARAM_DTYPE, device=dev)}

        p: dict = {}
        if cfg.has_attention:
            p["attn_norm"] = norm()
            p["attn"] = {
                "q": stacked_dense(d, cfg.attn_dim),
                "k": stacked_dense(d, cfg.kv_dim),
                "v": stacked_dense(d, cfg.kv_dim),
                "o": stacked_dense(cfg.attn_dim, d),
            }
        if cfg.has_ssm:
            p["ssm_norm"] = norm()
            p["ssm"] = self._init_ssm(gen, dev, stacked_dense)
        if cfg.family == "hybrid":
            p["attn_out_norm"] = norm()
            p["ssm_out_norm"] = norm()
        if ffn_kind == "moe":
            p["mlp_norm"] = norm()
            p["moe"] = moe_init(cfg, gen, lead=(n,), device=dev)
        elif ffn_kind == "mlp":
            ff = cfg.d_ff_dense if (cfg.family == "moe" and cfg.d_ff_dense) else cfg.d_ff
            p["mlp_norm"] = norm()
            if cfg.mlp_type == "swiglu":
                p["mlp"] = {"gate": stacked_dense(d, ff), "up": stacked_dense(d, ff),
                            "down": stacked_dense(ff, d)}
            else:
                p["mlp"] = {"up": stacked_dense(d, ff), "down": stacked_dense(ff, d)}
        return p

    def _init_ssm(self, gen, dev, stacked_dense) -> dict:
        """``repro.models.ssm.ssm_init``, stacked over layers."""
        cfg = self.cfg
        L, d = self.n_steps, cfg.d_model
        di, ns, nh = cfg.ssm_inner, cfg.ssm_state, cfg.ssm_heads
        conv_dim = di + 2 * ns  # x, B, C share the depthwise conv (ngroups=1)
        conv_w = torch.empty((L, cfg.ssm_conv, conv_dim), dtype=PARAM_DTYPE, device=dev)
        for layer in range(L):
            normal_(conv_w[layer], gen, 0.1)
        dt_bias = torch.rand((L, nh), generator=gen, device=dev) * 3.0 - 4.0  # U(-4, -1)
        return {
            "in_proj": stacked_dense(d, 2 * di + 2 * ns + nh),  # [z | xBC | dt]
            "conv_w": conv_w,
            "conv_b": torch.zeros((L, conv_dim), dtype=PARAM_DTYPE, device=dev),
            "a_log": torch.log(torch.linspace(1.0, 16.0, nh, device=dev))[None].repeat(L, 1),
            "dt_bias": dt_bias,
            "d_skip": torch.ones((L, nh), dtype=torch.float32, device=dev),
            "out_norm": {"scale": torch.ones((L, di), dtype=PARAM_DTYPE, device=dev)},
            "out_proj": stacked_dense(di, d),
        }

    def _apply_ffn(self, p, x, ffn_kind: str):
        """The residual branch of the sub-layer's FFN on x [..., d] and its
        load-balance loss (None but for MoE): a dense MLP, or MoE over x as
        one row of tokens per leading index (the decode step's [b, d] as b
        rows of one token, as the reference's ``[:, None, :]``)."""
        hn = rmsnorm(p["mlp_norm"], x, self.cfg.norm_eps)
        if ffn_kind == "moe":
            y, aux = moe_apply(p["moe"], hn if hn.dim() == 3 else hn[:, None, :], self.cfg)
            return (y if x.dim() == 3 else y[:, 0]), aux
        if self.cfg.mlp_type == "swiglu":
            return swiglu(p["mlp"], hn), None
        return gelu_mlp(p["mlp"], hn), None

    def _mix(self, p, outs: dict):
        """The token mixers' sum into the residual: the one branch, or the
        hybrid's per-branch RMSNorm mean."""
        if self.cfg.family != "hybrid":
            (y,) = outs.values()
            return y
        eps = self.cfg.norm_eps
        return 0.5 * (rmsnorm(p["attn_out_norm"], outs["attn"], eps)
                      + rmsnorm(p["ssm_out_norm"], outs["ssm"], eps))

    def _logits(self, params, x):
        table = params.get("lm_head", params["embed"])["table"]
        return x @ table.T.to(x.dtype)

    def _tokens(self, tokens) -> torch.Tensor:
        return torch.as_tensor(tokens, device=self.device).long()

    # ------------------------------------------------- full-seq forward
    def _sub_full(self, p, x, positions, ffn_kind: str, return_kv: bool = True):
        """One layer over the whole sequence -> (x, its KV / SSM caches when
        ``return_kv``, its MoE load-balance loss or None)."""
        cfg = self.cfg
        outs, caches = {}, {}
        if cfg.has_attention:
            h = rmsnorm(p["attn_norm"], x, cfg.norm_eps)
            b, s, _ = h.shape
            q = dense(p["attn"]["q"], h).reshape(b, s, cfg.num_heads, cfg.head_dim)
            k = dense(p["attn"]["k"], h).reshape(b, s, cfg.num_kv_heads, cfg.head_dim)
            v = dense(p["attn"]["v"], h).reshape(b, s, cfg.num_kv_heads, cfg.head_dim)
            q = rope(q, positions, cfg.rope_theta)
            k = rope(k, positions, cfg.rope_theta)
            a = flash_attention(q, k, v, causal=True, sliding_window=cfg.sliding_window,
                                prefix_len=cfg.num_meta_tokens)
            outs["attn"] = dense(p["attn"]["o"], a.reshape(b, s, -1))
            if return_kv:
                caches["k"], caches["v"] = k, v
        if cfg.has_ssm:
            h = rmsnorm(p["ssm_norm"], x, cfg.norm_eps)
            outs["ssm"], (ssd, conv) = ssm_prefill(p["ssm"], h, cfg)
            if return_kv:
                caches["ssd"], caches["conv"] = ssd, conv
        x = x + self._mix(p, outs)
        aux = None
        if ffn_kind != "none":
            y, aux = self._apply_ffn(p, x, ffn_kind)
            x = x + y
        return x, caches, aux

    def _embed_inputs(self, params, tokens, vision_embeds=None):
        """Token embeddings, with the VLM's image embeddings early-fused in
        front of the text (cast to the embedding dtype) and the meta-token
        prefix in front of everything (hymba).  Returns (x, offset) where
        offset is where text starts."""
        cfg = self.cfg
        x = params["embed"]["table"][tokens]
        offset = 0
        if cfg.family == "vlm" and vision_embeds is not None:
            vis = torch.as_tensor(vision_embeds, device=self.device).to(x.dtype)
            x = torch.cat([vis, x], dim=1)
            offset += vis.shape[1]
        if cfg.num_meta_tokens:
            meta = params["meta"][None].expand(x.shape[0], -1, -1).to(x.dtype)
            x = torch.cat([meta, x], dim=1)
            offset += cfg.num_meta_tokens
        return x, offset

    # ------------------------------------------------------------ train
    def _group_train(self, p, x, positions):
        """One layer group of the training forward -> (x, the group's summed
        MoE load-balance loss, f32)."""
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for i in range(self.group):
            x, _, a = self._sub_full(p if self.group == 1 else p[f"sub{i}"], x, positions,
                                     self._sub_kind(i), return_kv=False)
            if a is not None:
                aux = aux + a
        return x, aux

    def train_loss(self, params, batch, *, remat: bool = True):
        """batch: tokens [b, s] (+ optional vision_embeds) -> (loss, {"nll",
        "aux"}): the mean next-token cross-entropy over the text positions
        (after a VLM's image tokens and any meta prefix), plus 0.01 × the
        mean MoE load-balance loss for MoE configs.  ``remat`` recomputes
        each layer group's forward in the backward instead of keeping its
        activations (so the flash_prefill kernel runs twice a layer)."""
        cfg = self.cfg
        tokens = self._tokens(batch["tokens"])
        x, offset = self._embed_inputs(params, tokens, batch.get("vision_embeds"))
        b, s_total = x.shape[:2]
        positions = torch.arange(s_total, device=self.device)[None, :].expand(b, s_total)
        aux = torch.zeros((), dtype=torch.float32, device=self.device)
        for step in range(self.n_steps):
            p = _layer(params["layers"], step)
            if remat:
                x, a = torch.utils.checkpoint.checkpoint(
                    self._group_train, p, x, positions, use_reentrant=False)
            else:
                x, a = self._group_train(p, x, positions)
            aux = aux + a
        aux = aux / cfg.num_layers
        x = rmsnorm(params["final_norm"], x, cfg.norm_eps)[:, offset:]
        logits = self._logits(params, x[:, :-1]).float()
        nll = sharded_nll(logits, tokens[:, 1:], cfg.vocab_size).mean()
        loss = nll + 0.01 * aux if cfg.family == "moe" else nll
        return loss, {"nll": nll, "aux": aux}

    # ---------------------------------------------------------- prefill
    def prefill(self, params, batch, *, max_blocks_margin: int = 16, remat: bool = True):
        """Run the prompt (image tokens of a VLM batch's ``vision_embeds``
        first), return (last-token logits, DecodeState); context lengths
        and positions count the image tokens.  ``remat`` is accepted for
        call compatibility; there is no backward here to rematerialize
        for."""
        del remat
        tokens = self._tokens(batch["tokens"])
        b = tokens.shape[0]
        x, _ = self._embed_inputs(params, tokens, batch.get("vision_embeds"))
        s_total = x.shape[1]
        positions = torch.arange(s_total, device=self.device)[None, :].expand(b, s_total)
        per_layer = []
        for _, p, kind in self._sublayers(params):
            x, caches, _ = self._sub_full(p, x, positions, kind)
            per_layer.append(caches)
        caches = {key: torch.stack([c[key] for c in per_layer]) for key in per_layer[0]}
        del per_layer
        x = rmsnorm(params["final_norm"], x, self.cfg.norm_eps)
        logits = self._logits(params, x[:, -1, :])
        return logits, self._caches_to_state(caches, b, s_total, max_blocks_margin)

    def _caches_to_state(self, caches, b, s_total, margin) -> DecodeState:
        """Per-layer prefill caches ([L, b, ...]) -> DecodeState: paged KV
        with ``margin`` empty pages after the prompt's and identity block
        tables; or, for sliding-window archs, a ring of ``window +
        BLOCK_SIZE`` slots holding the newest tokens plus the meta KV; and
        the SSM states as they are."""
        cfg = self.cfg
        bs = self.BLOCK_SIZE
        dev = self.device
        state = DecodeState(
            context_lens=torch.full((b,), s_total, dtype=torch.int32, device=dev))
        if cfg.has_attention:
            k, v = caches["k"], caches["v"]  # [L, b, s, g, hd]
            L, _, _, g, hd = k.shape
            if cfg.sliding_window:
                m = cfg.num_meta_tokens
                cap = cfg.sliding_window + bs
                if m:
                    state.meta_k, state.meta_v = k[:, :, :m], v[:, :, :m]
                    k, v = k[:, :, m:], v[:, :, m:]
                s = k.shape[2]
                take = min(cap, s)
                tail_pos = torch.arange(s - take, s, device=dev) + m  # absolute positions
                slots = tail_pos % cap
                state.ring_k = torch.zeros((L, b, cap, g, hd), dtype=k.dtype, device=dev)
                state.ring_v = torch.zeros_like(state.ring_k)
                state.ring_k[:, :, slots] = k[:, :, s - take:]
                state.ring_v[:, :, slots] = v[:, :, s - take:]
                state.ring_pos = torch.full((b, cap), -1, dtype=torch.int32, device=dev)
                state.ring_pos[:, slots] = tail_pos.to(torch.int32)
            else:
                state.k_pages, state.v_pages, state.block_tables = paged_kv(k, v, bs, margin)
        if cfg.has_ssm:
            state.ssd_state = caches["ssd"]    # [L, b, nh, hd, ns]
            state.conv_state = caches["conv"]  # [L, b, k-1, c]
        return state

    def decode_state_shape(self, batch: int, context_len: int, *, margin: int = 16,
                           dtype: torch.dtype = torch.bfloat16) -> DecodeState:
        """A decode state holding ``context_len`` tokens as meta tensors
        (shapes and dtypes, no storage) — the reference's ShapeDtypeStruct
        tree."""
        cfg = self.cfg
        bs = self.BLOCK_SIZE
        L, g, hd = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim

        def meta(shape, dt=dtype):
            return torch.empty(shape, dtype=dt, device="meta")

        state = DecodeState(context_lens=meta((batch,), torch.int32))
        if cfg.has_attention:
            if cfg.sliding_window:
                cap = cfg.sliding_window + bs
                state.ring_k = meta((L, batch, cap, g, hd))
                state.ring_v = meta((L, batch, cap, g, hd))
                state.ring_pos = meta((batch, cap), torch.int32)
                if cfg.num_meta_tokens:
                    state.meta_k = meta((L, batch, cfg.num_meta_tokens, g, hd))
                    state.meta_v = meta((L, batch, cfg.num_meta_tokens, g, hd))
            else:
                per_seq = -(-context_len // bs) + margin
                state.k_pages = meta((L, batch, per_seq, bs, g, hd))
                state.v_pages = meta((L, batch, per_seq, bs, g, hd))
                state.block_tables = meta((batch, per_seq), torch.int32)
        if cfg.has_ssm:
            ssd_shape, conv_shape = ssm_state_shapes(cfg, batch)
            state.ssd_state = meta((L,) + ssd_shape, torch.float32)
            state.conv_state = meta((L,) + conv_shape)
        return state

    # ------------------------------------------------------ decode step
    def _attn_qkv(self, p, h, pos):
        cfg = self.cfg
        b, _ = h.shape
        hn = rmsnorm(p["attn_norm"], h, cfg.norm_eps)
        q = dense(p["attn"]["q"], hn).reshape(b, 1, cfg.num_heads, cfg.head_dim)
        k = dense(p["attn"]["k"], hn).reshape(b, 1, cfg.num_kv_heads, cfg.head_dim)
        v = dense(p["attn"]["v"], hn).reshape(b, 1, cfg.num_kv_heads, cfg.head_dim)
        q = rope(q, pos[:, None], cfg.rope_theta)[:, 0]
        k = rope(k, pos[:, None], cfg.rope_theta)[:, 0]
        return q, k, v[:, 0]

    def _sub_decode(self, p, h, state: DecodeState, layer: int, pages: KVPages | None,
                    ffn_kind: str):
        """One layer of one decode step.  ``pages``: this layer's KV pages
        (paged archs); ring slots are written in place; returns (h, pages,
        (ssd, conv) or None)."""
        cfg = self.cfg
        b, _ = h.shape
        outs = {}
        ssm_state = None
        if cfg.has_attention:
            q, k, v = self._attn_qkv(p, h, state.context_lens)
            if cfg.sliding_window:
                a = self._ring_attention(q, k, v, state, layer)
            else:
                a, pages = paged_decode_with_write(q, k, v, pages, state.block_tables,
                                                   state.context_lens)
            outs["attn"] = dense(p["attn"]["o"], a.reshape(b, -1))
        if cfg.has_ssm:
            hn = rmsnorm(p["ssm_norm"], h, cfg.norm_eps)
            outs["ssm"], ssm_state = ssm_step(
                p["ssm"], hn, cfg, (state.ssd_state[layer], state.conv_state[layer]))
        h = h + self._mix(p, outs)
        if ffn_kind != "none":
            h = h + self._apply_ffn(p, h, ffn_kind)[0]
        return h, pages, ssm_state

    def _ring_attention(self, q, k_new, v_new, state: DecodeState, layer: int):
        """Sliding-window decode over layer ``layer``'s ring (the new token
        written into its slot in place; ``state.ring_pos`` already holds
        its position) and the always-visible meta KV.  Plain torch."""
        cfg = self.cfg
        b = q.shape[0]
        pos = state.context_lens
        ring_k, ring_v = state.ring_k[layer], state.ring_v[layer]
        rows = torch.arange(b, device=q.device)
        slot = (pos % ring_k.shape[1]).long()
        ring_k[rows, slot] = k_new.to(ring_k.dtype)
        ring_v[rows, slot] = v_new.to(ring_v.dtype)

        ks, vs, ps = ring_k, ring_v, state.ring_pos
        slot_valid = (ps >= 0) & (ps <= pos[:, None]) & (ps > pos[:, None] - cfg.sliding_window)
        if state.meta_k is not None:
            ks = torch.cat([state.meta_k[layer], ks], dim=1)
            vs = torch.cat([state.meta_v[layer], vs], dim=1)
            meta_valid = torch.ones((b, state.meta_k.shape[2]), dtype=torch.bool,
                                    device=q.device)
            slot_valid = torch.cat([meta_valid, slot_valid], dim=1)
        g = ks.shape[2]
        hq = q.reshape(b, g, cfg.num_heads // g, cfg.head_dim)
        scores = torch.einsum("bgqd,bsgd->bgqs", hq, ks).float() * (cfg.head_dim ** -0.5)
        scores = scores.masked_fill(~slot_valid[:, None, None, :], float("-inf"))
        w = torch.softmax(scores, dim=-1).to(vs.dtype)
        return torch.einsum("bgqs,bsgd->bgqd", w, vs).reshape(b, cfg.num_heads, cfg.head_dim)

    def decode_step(self, params, state: DecodeState, tokens):
        """One token for every sequence.  tokens: [b] -> (logits [b, V],
        new DecodeState sharing ``state``'s pages and rings, updated in
        place, with fresh SSM states)."""
        cfg = self.cfg
        x = params["embed"]["table"][self._tokens(tokens)]
        new = dataclasses.replace(state)
        if state.ring_pos is not None:  # every layer writes the same slot and position
            pos = state.context_lens
            rows = torch.arange(pos.shape[0], device=pos.device)
            new.ring_pos = state.ring_pos.clone()
            new.ring_pos[rows, (pos % new.ring_pos.shape[1]).long()] = pos
        ssd, conv = [], []
        for layer, p, kind in self._sublayers(params):
            pages = None
            if state.k_pages is not None:
                pages = KVPages(state.k_pages[layer], state.v_pages[layer])
            x, _, ssm_state = self._sub_decode(p, x, new, layer, pages, kind)
            if ssm_state is not None:
                ssd.append(ssm_state[0])
                conv.append(ssm_state[1])
        x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
        logits = self._logits(params, x)
        if ssd:
            new.ssd_state, new.conv_state = torch.stack(ssd), torch.stack(conv)
        new.context_lens = state.context_lens + 1
        return logits, new

    def decode_step_layerwise(self, params, state: DecodeState, tokens, fetch_layer):
        """One decode step where layer ``l``'s KV pages come from
        ``fetch_layer(l) -> (k_pages_l, v_pages_l)`` (each [b, per_seq, bs,
        g, hd]) right before layer ``l``'s attention — the compute half of
        the layer-streamed pull.  Same per-layer math as ``decode_step``,
        so logits and pages are identical to the full-state step.  The
        returned state stacks the fetched pages (with the new token).
        Paged-KV archs only, as in the reference."""
        cfg = self.cfg
        if not cfg.has_attention or cfg.sliding_window or cfg.has_ssm:
            raise NotImplementedError(
                "layerwise decode covers paged-KV attention archs; ring/SSM "
                "caches have no layer-streamed pull to consume")
        x = params["embed"]["table"][self._tokens(tokens)]
        new_k, new_v = [], []
        for layer, p, kind in self._sublayers(params):
            pages = KVPages(*fetch_layer(layer))
            x, pages, _ = self._sub_decode(p, x, state, layer, pages, kind)
            new_k.append(pages.k_pages)
            new_v.append(pages.v_pages)
        x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
        logits = self._logits(params, x)
        return logits, dataclasses.replace(
            state, k_pages=torch.stack(new_k), v_pages=torch.stack(new_v),
            context_lens=state.context_lens + 1)
