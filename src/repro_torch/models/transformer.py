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

Under a device mesh (``models.sharding``; params from
``launch.shardings.shard_params``) the dense and MoE families compute on
this rank's shards, the collectives the reference's partitioner inserts
written out: heads over 'model' by the GQA policy (k and v gathered after
their column-parallel projection when the kv groups do not divide TP),
row-parallel ``o`` and ``down`` summed over 'model', a vocab-sharded
embedding and lm head (logits are this rank's vocab columns), the MoE
expert exchange (``models.moe``).  ``prefill`` takes the mesh axes its
batch rows are split over (``batch_axes``) and lays its KV, computed with
the rank's kv groups or batch rows, into the decode state's layout
(``launch.shardings.decode_state_sharding``: the pages' per_seq over
'model' when it divides, else whole) with one all_to_all over 'model'
(an all_gather when the pages stay whole); the state's ``layout`` says
which, and the decode step runs the sequence-parallel branch of
``paged_decode_with_write`` on it.  ``train_loss`` under a mesh runs the
reference's ``mode="train"`` placements: FSDP over 'data' (each layer
group's shards gathered inside its remat region), TP over 'model', the
vocab-sharded loss, the mean over the global batch (the gradient
convention of ``models.sharding``).  The SSM, hybrid and sliding-window
families and image prompts refuse a 'model' axis of more than one rank
(the SSM family trains under FSDP at 'model' = 1), and
``models.whisper`` any mesh (ROADMAP.md, queue 1).
"""
from __future__ import annotations

import dataclasses

import torch
import torch.utils.checkpoint

from repro_torch.device import resolve_device
from repro_torch.models import sharding
from repro_torch.models.attention import KVPages, identity_slice, paged_decode_with_write, rope
from repro_torch.models.config import ModelConfig
from repro_torch.models.flash import flash_attention
from repro_torch.models.layers import (
    PARAM_DTYPE, column_input, dense, dense_init, embed, gelu_mlp, normal_, rmsnorm, row_dense,
    swiglu)
from repro_torch.models.moe import moe_apply, moe_init
from repro_torch.models.sharding import MeshLayout
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
    # under a mesh: how the tensors above are split (None: whole)
    layout: MeshLayout | None = None


def stack_states(states) -> DecodeState:
    """DecodeStates of single sequences -> one state at b = len(states),
    in new tensors.  For ring, meta and SSM states only: their shapes do
    not depend on the prompt's length (paged KV would need a common
    per-sequence block count)."""
    out = {}
    for f in dataclasses.fields(DecodeState):
        vals = [getattr(st, f.name) for st in states]
        if vals[0] is None or f.name == "layout":
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


def sharded_nll(logits: torch.Tensor, labels: torch.Tensor, vocab_size: int,
                full: int | None = None) -> torch.Tensor:
    """Per-position cross-entropy over the real vocabulary (the padded
    logits masked to -inf): logsumexp − the label's logit, the reference's
    ``_sharded_nll``.  ``full``: the logits' full width (the padded
    vocabulary); when ``logits`` hold fewer columns they are this rank's
    vocab columns over 'model', and the reference's one-hot select keeps
    the vocab axis sharded: the global column index is this rank's offset
    plus the local one, the padded columns are masked by it, and the local
    max (all-reduced with ``max``, no gradient), the local sum of
    exponentials and the label's logit (both all-reduced with ``sum``)
    give every rank the whole row's value.  One device: the label's logit
    is a gather."""
    n = logits.shape[-1]
    if full is None or n == full:
        valid = torch.arange(n, device=logits.device) < vocab_size
        lse = torch.logsumexp(logits.masked_fill(~valid, float("-inf")), dim=-1)
        return lse - torch.gather(logits, -1, labels[..., None].long())[..., 0]
    lo = sharding.axis_index("model") * n
    cols = torch.arange(lo, lo + n, device=logits.device)
    masked = logits.masked_fill(cols >= vocab_size, float("-inf"))
    m = sharding.all_reduce(masked.amax(dim=-1), "model", "max")
    sumexp = sharding.all_reduce(torch.exp(masked - m[..., None]).sum(-1), "model")
    label = torch.where(cols == labels[..., None].long(), logits, 0.0).sum(-1)
    return torch.log(sumexp) + m - sharding.all_reduce(label, "model")


_REFUSED = "under a 'model' axis of more than one rank (ROADMAP.md, queue 1, item 3)"


def _layer(tree, i: int):
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def _fsdp_gather(tree, plan, shift: int = 0):
    """Each leaf of ``tree`` gathered along the (dim, axes) pairs of its
    entry in ``plan`` (``launch.shardings.fsdp_plan``): its train shard
    made its serving shard.  ``shift``: how many leading dims the leaves
    have lost against the plan's (1 for one layer of the stack)."""
    if isinstance(tree, dict):
        return {k: _fsdp_gather(v, plan[k], shift) for k, v in tree.items()}
    for dim, axes in plan:
        tree = sharding.all_gather(tree, axes, dim - shift)
    return tree


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
        self._fsdp_plans: dict = {}   # (mesh shape, fold) -> fsdp_plan

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
        JAX weights over with ``bridge.params_from_jax`` instead.
        ``device="meta"``: the shapes and dtypes alone (``param_shapes``)."""
        cfg = self.cfg
        dev = self.device if device is None else \
            torch.device("meta") if str(device) == "meta" else resolve_device(device)
        gen = torch.Generator(device="cpu" if dev.type == "meta" else dev).manual_seed(seed)
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

    def param_shapes(self) -> dict:
        """The params as meta tensors: the full shapes and dtypes, no
        storage (the reference's ``jax.eval_shape`` of ``init_params``)."""
        return self.init_params(device="meta")

    def _fsdp_plan(self):
        """Under a mesh, the FSDP gathers of every leaf of the train
        placements (``launch.shardings.fsdp_plan``), made once a mesh shape;
        None without a mesh."""
        mesh = sharding.get_mesh()
        if mesh is None:
            return None
        from repro_torch.launch.shardings import fsdp_plan

        key = (tuple(mesh.shape.items()), sharding.tp_folded())
        if key not in self._fsdp_plans:
            self._fsdp_plans[key] = fsdp_plan(self.param_shapes(), mesh,
                                              fold_model=sharding.tp_folded())
        return self._fsdp_plans[key]

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

    def _apply_ffn(self, p, x, ffn_kind: str, batch_axes=()):
        """The residual branch of the sub-layer's FFN on x [..., d] and its
        load-balance loss (None but for MoE): a dense MLP (on the rank's
        d_ff under TP), or MoE over x as one row of tokens per leading
        index (the decode step's [b, d] as b rows of one token, as the
        reference's ``[:, None, :]``; ``batch_axes``: the mesh axes x's
        rows are split over)."""
        cfg = self.cfg
        hn = rmsnorm(p["mlp_norm"], x, cfg.norm_eps)
        if ffn_kind == "moe":
            y, aux = moe_apply(p["moe"], hn if hn.dim() == 3 else hn[:, None, :], cfg,
                               batch_axes=batch_axes)
            return (y if x.dim() == 3 else y[:, 0]), aux
        ff = cfg.d_ff_dense if (cfg.family == "moe" and cfg.d_ff_dense) else cfg.d_ff
        if cfg.mlp_type == "swiglu":
            return swiglu(p["mlp"], hn, ff), None
        return gelu_mlp(p["mlp"], hn, ff), None

    def _heads(self, p, x, n: int):
        """x [..., d] -> [..., heads, hd] through a column-parallel weight:
        this rank's heads when the n heads shard over TP (the GQA policy),
        else all n (the columns gathered over 'model' when the weight
        split them off head boundaries)."""
        y = dense(p, x)
        if y.shape[-1] < n * self.cfg.head_dim and not sharding.heads_sharded(n):
            y = sharding.all_gather(y, "model", -1)
        return y.reshape(*y.shape[:-1], -1, self.cfg.head_dim)

    def _kv_for(self, q, k, v):
        """The kv groups of q's heads [b, s, h_l, d]: k and v as they are
        when they hold exactly those groups; this rank's slice of whole
        groups when only the heads shard over TP (or one group a head,
        where the heads straddle groups)."""
        cfg = self.cfg
        h_l, qpg = q.shape[2], cfg.num_heads // cfg.num_kv_heads
        if h_l == k.shape[2] * qpg:
            return k, v
        h0 = sharding.axis_index("model") * h_l
        if qpg % h_l == 0 or (h0 % qpg == 0 and h_l % qpg == 0):
            idx = slice(h0 // qpg, (h0 + h_l - 1) // qpg + 1)
        else:
            idx = torch.arange(h0, h0 + h_l, device=k.device) // qpg
        return k[:, :, idx].contiguous(), v[:, :, idx].contiguous()

    def _check_mesh(self, vision: bool = False):
        cfg = self.cfg
        if sharding.axis_size("model") > 1 and (cfg.has_ssm or cfg.sliding_window or vision):
            what = ("image prompts" if vision else "the SSM and hybrid families"
                    if cfg.has_ssm else "sliding-window attention")
            raise NotImplementedError(f"{cfg.name}: {what} {_REFUSED}")

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
        """x @ table.T: this rank's vocab columns when the table is
        vocab-sharded (its input then a column-parallel product's)."""
        table = params.get("lm_head", params["embed"])["table"]
        x = column_input(x, table.T, self.cfg.padded_vocab)
        return x @ table.T.to(x.dtype)

    def _tokens(self, tokens) -> torch.Tensor:
        return torch.as_tensor(tokens, device=self.device).long()

    # ------------------------------------------------- full-seq forward
    def _sub_full(self, p, x, positions, ffn_kind: str, return_kv: bool = True,
                  batch_axes=()):
        """One layer over the whole sequence -> (x, its KV / SSM caches when
        ``return_kv``, its MoE load-balance loss or None).  Under TP, q, k
        and v hold this rank's heads and groups (the caches too)."""
        cfg = self.cfg
        outs, caches = {}, {}
        if cfg.has_attention:
            h = column_input(rmsnorm(p["attn_norm"], x, cfg.norm_eps), p["attn"]["q"]["w"],
                             cfg.attn_dim)
            b, s, _ = h.shape
            q = rope(self._heads(p["attn"]["q"], h, cfg.num_heads), positions, cfg.rope_theta)
            k = rope(self._heads(p["attn"]["k"], h, cfg.num_kv_heads), positions,
                     cfg.rope_theta)
            v = self._heads(p["attn"]["v"], h, cfg.num_kv_heads)
            kq, vq = self._kv_for(q, k, v)
            a = flash_attention(q, kq, vq, causal=True, sliding_window=cfg.sliding_window,
                                prefix_len=cfg.num_meta_tokens)
            outs["attn"] = row_dense(p["attn"]["o"], a.reshape(b, s, -1), cfg.attn_dim)
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
            y, aux = self._apply_ffn(p, x, ffn_kind, batch_axes)
            x = x + y
        return x, caches, aux

    def _embed_inputs(self, params, tokens, vision_embeds=None):
        """Token embeddings, with the VLM's image embeddings early-fused in
        front of the text (cast to the embedding dtype) and the meta-token
        prefix in front of everything (hymba).  Returns (x, offset) where
        offset is where text starts."""
        cfg = self.cfg
        x = embed(params["embed"], tokens, cfg.padded_vocab)
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
    def _group_train(self, p, x, positions, plan=None, batch_axes=()):
        """One layer group of the training forward -> (x, the group's summed
        MoE load-balance loss, f32).  Under a mesh ``p`` holds the group's
        train shards, gathered here over their FSDP axes (``plan``): inside
        the remat region, so that the gathered weights are freed after the
        group and gathered again in the backward."""
        if plan is not None:
            p = _fsdp_gather(p, plan, shift=1)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for i in range(self.group):
            x, _, a = self._sub_full(p if self.group == 1 else p[f"sub{i}"], x, positions,
                                     self._sub_kind(i), return_kv=False, batch_axes=batch_axes)
            if a is not None:
                aux = aux + a
        return x, aux

    def train_loss(self, params, batch, *, remat: bool = True, batch_axes: tuple[str, ...] = ()):
        """batch: tokens [b, s] (+ optional vision_embeds) -> (loss, {"nll",
        "aux"}): the mean next-token cross-entropy over the text positions
        (after a VLM's image tokens and any meta prefix), plus 0.01 × the
        mean MoE load-balance loss for MoE configs.  ``remat`` recomputes
        each layer group's forward in the backward instead of keeping its
        activations (so the flash_prefill kernel runs twice a layer).

        Under a mesh (``models.sharding``): ``params`` are this rank's train
        shards (``launch.shardings.shard_params(..., mode="train")``), each
        layer group's FSDP leaves gathered inside its remat region, the
        embedding, lm head and final norm by their own placements; the batch
        holds this rank's rows, split over ``batch_axes`` (``batch_spec``);
        the loss is the mean over the GLOBAL batch, the same scalar on every
        rank, its gradient shared among the ranks of the DP axes the batch
        is not split over (they compute it alike)."""
        cfg = self.cfg
        self._check_mesh(vision=batch.get("vision_embeds") is not None)
        plan = self._fsdp_plan()

        def top(name):
            if plan is None or name not in params:
                return params.get(name)
            return _fsdp_gather(params[name], plan[name])

        tokens = self._tokens(batch["tokens"])
        x, offset = self._embed_inputs({"embed": top("embed"), "meta": top("meta")}, tokens,
                                       batch.get("vision_embeds"))
        b, s_total = x.shape[:2]
        positions = torch.arange(s_total, device=self.device)[None, :].expand(b, s_total)
        aux = torch.zeros((), dtype=torch.float32, device=self.device)
        layer_plan = None if plan is None else plan["layers"]
        for step in range(self.n_steps):
            p = _layer(params["layers"], step)
            if remat:
                x, a = torch.utils.checkpoint.checkpoint(
                    self._group_train, p, x, positions, layer_plan, batch_axes,
                    use_reentrant=False)
            else:
                x, a = self._group_train(p, x, positions, layer_plan, batch_axes)
            aux = aux + a
        aux = aux / cfg.num_layers
        x = rmsnorm(top("final_norm"), x, cfg.norm_eps)[:, offset:]
        head = "lm_head" if "lm_head" in params else "embed"
        logits = self._logits({"embed": top(head)}, x[:, :-1]).float()
        nll = sharded_nll(logits, tokens[:, 1:], cfg.vocab_size, cfg.padded_vocab)
        split = sharding.axis_size(batch_axes)
        if split == 1:
            nll = nll.mean()
        else:
            nll = sharding.all_reduce(nll.sum(), batch_axes) / (nll.numel() * split)
        loss = nll + 0.01 * aux if cfg.family == "moe" else nll
        rest = tuple(a for a in sharding.dp_axes() if a not in batch_axes)
        return sharding.share_grad(loss, rest), {"nll": nll, "aux": aux}

    # ---------------------------------------------------------- prefill
    def prefill(self, params, batch, *, max_blocks_margin: int = 16, remat: bool = True,
                batch_axes: tuple[str, ...] = ()):
        """Run the prompt (image tokens of a VLM batch's ``vision_embeds``
        first), return (last-token logits, DecodeState); context lengths
        and positions count the image tokens.  ``remat`` is accepted for
        call compatibility; there is no backward here to rematerialize
        for.  Under a mesh the batch holds this rank's rows, split over
        ``batch_axes``."""
        del remat
        self._check_mesh(vision=batch.get("vision_embeds") is not None)
        tokens = self._tokens(batch["tokens"])
        b = tokens.shape[0]
        x, _ = self._embed_inputs(params, tokens, batch.get("vision_embeds"))
        s_total = x.shape[1]
        positions = torch.arange(s_total, device=self.device)[None, :].expand(b, s_total)
        per_layer = []
        for _, p, kind in self._sublayers(params):
            x, caches, _ = self._sub_full(p, x, positions, kind, batch_axes=batch_axes)
            per_layer.append(caches)
        caches = {key: torch.stack([c[key] for c in per_layer]) for key in per_layer[0]}
        del per_layer
        x = rmsnorm(params["final_norm"], x, self.cfg.norm_eps)
        logits = self._logits(params, x[:, -1, :])
        return logits, self._caches_to_state(caches, b, s_total, max_blocks_margin, batch_axes)

    def _place_pages(self, k_pages, v_pages, batch_axes):
        """Prefill pages [L, b, per_seq, bs, g, hd], computed with this
        rank's kv groups (TP) or batch rows (batch split over 'model' in the
        folded deployment) -> the decode state's layout: the pages' per_seq
        over 'model' when it divides (one all_to_all: the rank's page slice
        of every group or row), else whole on every rank (an all_gather of
        the groups or rows).  Returns (k_pages, v_pages, MeshLayout)."""
        tp = sharding.axis_size("model")
        seq_parallel = tp > 1 and k_pages.shape[2] % tp == 0
        src = (4 if k_pages.shape[4] < self.cfg.num_kv_heads
               else 1 if "model" in batch_axes else None)

        def place(x):
            if src is not None and seq_parallel:
                return sharding.all_to_all(x, "model", split_dim=2, concat_dim=src)
            if src is not None:
                return sharding.all_gather(x, "model", src)
            return sharding.take_shard(x, "model", 2).contiguous() if seq_parallel else x

        layout = MeshLayout(tuple(a for a in batch_axes if a != "model"), seq_parallel)
        return place(k_pages), place(v_pages), layout

    def _caches_to_state(self, caches, b, s_total, margin, batch_axes=()) -> DecodeState:
        """Per-layer prefill caches ([L, b, ...]) -> DecodeState: paged KV
        with ``margin`` empty pages after the prompt's and identity block
        tables (under a mesh, placed by ``_place_pages``); or, for
        sliding-window archs, a ring of ``window + BLOCK_SIZE`` slots
        holding the newest tokens plus the meta KV; and the SSM states as
        they are."""
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
                if sharding.get_mesh() is not None:
                    state.k_pages, state.v_pages, state.layout = self._place_pages(
                        state.k_pages, state.v_pages, batch_axes)
                    b, pps = state.k_pages.shape[1], state.k_pages.shape[2]
                    state.context_lens = torch.full((b,), s_total, dtype=torch.int32,
                                                    device=dev)
                    state.block_tables = (identity_slice(b, pps, dev)
                                          if state.layout.seq_parallel
                                          else state.block_tables[:1].repeat(b, 1))
        if cfg.has_ssm:
            state.ssd_state = caches["ssd"]    # [L, b, nh, hd, ns]
            state.conv_state = caches["conv"]  # [L, b, k-1, c]
        if sharding.get_mesh() is not None and state.layout is None:
            state.layout = MeshLayout(tuple(a for a in batch_axes if a != "model"))
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
        """The new token's q, k, v [b, heads, hd] (this rank's heads and
        groups under TP)."""
        cfg = self.cfg
        hn = rmsnorm(p["attn_norm"], h, cfg.norm_eps)
        q = self._heads(p["attn"]["q"], hn, cfg.num_heads)[:, None]
        k = self._heads(p["attn"]["k"], hn, cfg.num_kv_heads)[:, None]
        v = self._heads(p["attn"]["v"], hn, cfg.num_kv_heads)
        q = rope(q, pos[:, None], cfg.rope_theta)[:, 0]
        k = rope(k, pos[:, None], cfg.rope_theta)[:, 0]
        return q, k, v

    def _paged_attention(self, q, k, v, pages: KVPages, state: DecodeState):
        """Decode attention over the paged KV: every head and group gathered
        over 'model' (the pages hold every group), the sequence-parallel
        branch when the state's pages split over 'model', then this rank's
        heads of the output."""
        cfg = self.cfg
        h_l = q.shape[1]
        if h_l < cfg.num_heads:
            q = sharding.all_gather(q, "model", 1)
        if k.shape[1] < cfg.num_kv_heads:
            k, v = sharding.all_gather(k, "model", 1), sharding.all_gather(v, "model", 1)
        seq_parallel = state.layout is not None and state.layout.seq_parallel
        a, pages = paged_decode_with_write(q, k, v, pages, state.block_tables,
                                           state.context_lens, seq_parallel=seq_parallel)
        if h_l < cfg.num_heads:
            a = sharding.take_shard(a, "model", 1)
        return a, pages

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
                a, pages = self._paged_attention(q, k, v, pages, state)
            outs["attn"] = row_dense(p["attn"]["o"], a.reshape(b, -1), cfg.attn_dim)
        if cfg.has_ssm:
            hn = rmsnorm(p["ssm_norm"], h, cfg.norm_eps)
            outs["ssm"], ssm_state = ssm_step(
                p["ssm"], hn, cfg, (state.ssd_state[layer], state.conv_state[layer]))
        h = h + self._mix(p, outs)
        if ffn_kind != "none":
            h = h + self._apply_ffn(p, h, ffn_kind,
                                    state.layout.batch_axes if state.layout else ())[0]
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
        self._check_mesh()
        x = embed(params["embed"], self._tokens(tokens), cfg.padded_vocab)
        if state.layout is not None and state.layout.seq_parallel:
            b, pps = state.block_tables.shape
            if not torch.equal(state.block_tables, identity_slice(b, pps, self.device)):
                raise ValueError("sequence-parallel decode needs the identity page layout: "
                                 "rank i holds pages [i*pps, (i+1)*pps) of every sequence")
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
