"""The designs of the two attention kernels, checked on the CPU.

``csrc/paged_attention.cu`` splits each sequence's pages into partitions
(``ops.partitions``), runs an f32 online softmax per stream of lanes in a
block, merges the streams and then the partitions with one formula:
out = sum_p acc_p 2^(m_p - M) / max(sum_p l_p 2^(m_p - M), 1e-30).  A
plain-torch model of that pass, with the wrapper's own partition choice,
must equal the plain version ``paged_attention_ref`` (f32, 1e-5) and the
JAX package's oracle.

``csrc/flash_prefill.cu`` visits, for each q tile, the k tiles
``ops.k_tiles`` lists; a property test holds that list against the masks
of ``dense_ref``: every visible (q, k) pair lies in a visited tile (so
every skipped tile is wholly masked), and for aligned lengths the list is
exactly ``models.flash.pair_schedule``'s.

Both wrappers hold these models' constants (``DESIGN``) against the
values the compiled kernels report before their first launch
(``build.check_design``); here a stand-in library plays the kernels.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.kernels.paged_attention.ref import paged_attention_ref as jax_paged_ref
from repro_torch.kernels import build
from repro_torch.kernels.flash_prefill import ops as flash_ops
from repro_torch.kernels.flash_prefill.ops import BF16_TILE, F32_TILE, k_tiles
from repro_torch.kernels.paged_attention import ops as paged_ops
from repro_torch.kernels.paged_attention.ops import (
    BLOCKS_PER_SM,
    HEADS_PER_BLOCK,
    KEY_BATCH,
    THREADS,
    partitions,
)
from repro_torch.kernels.paged_attention.ref import paged_attention_ref
from repro_torch.models.flash import pair_schedule

NEG = -1e30
H100_SMS = 132


def merge(parts):
    """(m, l, acc) partials in the log2 domain -> one (m, l, acc)."""
    m = torch.stack([p[0] for p in parts]).amax(0)
    w = [torch.exp2(p[0] - m) for p in parts]
    return (m, sum(p[1] * wi for p, wi in zip(parts, w)),
            sum(p[2] * wi[:, None] for p, wi in zip(parts, w)))


def split_kv_model(q, k_pages, v_pages, tables, ctx, sm_count):
    """The split-KV pass as the kernels run it: partitions of ``pages``
    pages, 128 / (d / 8) streams of lanes per block, each over every
    NG-th batch of KEY_BATCH keys with its own online softmax, the streams
    merged in the block, the live partitions merged by the combine."""
    b, h, d = q.shape
    _, per, bs, g, _ = k_pages.shape
    qpg = h // g
    pages, n_part = partitions(b, g, qpg, per, sm_count)
    ng, nb = THREADS // (d // 8), KEY_BATCH[q.dtype]
    scale = d ** -0.5 * math.log2(math.e)
    out = torch.empty_like(q)
    for seq in range(b):
        c = int(ctx[seq])
        for kvh in range(g):
            heads = slice(kvh * qpg, (kvh + 1) * qpg)
            qs = q[seq, heads] * scale
            partials = []
            for part in range(n_part):
                tok0 = part * pages * bs
                if part > 0 and tok0 >= c:
                    continue  # the block exits; the combine reads only live ones
                n_keys = max(0, min(pages * bs, c - tok0, per * bs - tok0))
                pos = tok0 + torch.arange(n_keys)
                blk = tables[seq, pos // bs].long()
                keys, vals = k_pages[seq, blk, pos % bs, kvh], v_pages[seq, blk, pos % bs, kvh]
                streams = []
                for stream in range(ng):
                    m, l_, acc = torch.full((qpg,), NEG), torch.zeros(qpg), torch.zeros(qpg, d)
                    for it in range(-(-n_keys // (ng * nb))):
                        base = (it * ng + stream) * nb
                        if base >= n_keys:
                            continue  # all masked: m, l, acc unchanged
                        idx = torch.arange(base, min(base + nb, n_keys))
                        s = qs @ keys[idx].T
                        mn = torch.maximum(m, s.amax(1))
                        corr, p = torch.exp2(m - mn), torch.exp2(s - mn[:, None])
                        l_, acc, m = l_ * corr + p.sum(1), acc * corr[:, None] + p @ vals[idx], mn
                    streams.append((m, l_, acc))
                partials.append(merge(streams))
            _, tot, acc = merge(partials)
            out[seq, heads] = acc / torch.clamp(tot, min=1e-30)[:, None]
    return out, pages, n_part


def pages_inputs(rng, b, h, g, d, per, bs, ctx, permute):
    q = rng.standard_normal((b, h, d)).astype(np.float32)
    kp = rng.standard_normal((b, per, bs, g, d)).astype(np.float32)
    vp = rng.standard_normal((b, per, bs, g, d)).astype(np.float32)
    tbl = np.stack([rng.permutation(per) if permute else np.arange(per)
                    for _ in range(b)]).astype(np.int32)
    return q, kp, vp, tbl, np.asarray(ctx, np.int32)


class TestSplitKV:
    @pytest.mark.parametrize("h,g", [(4, 4), (10, 2), (16, 2)])  # qpg 1, 5, 8
    @pytest.mark.parametrize("where", ["one token", "partition edge", "trailing empty",
                                       "full"])
    @pytest.mark.parametrize("sm_count", [H100_SMS, 2])
    def test_model_equals_plain_version(self, h, g, where, sm_count):
        b, d, per, bs = 3, 32, 8, 4
        pages, n_part = partitions(b, g, h // g, per, sm_count)
        edge = pages * bs
        ctx = {"one token": [1, 1, 1], "partition edge": [edge, 2 * edge, per * bs],
               "trailing empty": [edge + 1, 3, edge - 1], "full": [per * bs] * 3}[where]
        rng = np.random.default_rng(h * 10 + g)
        q, kp, vp, tbl, ctx = map(torch.from_numpy,
                                  pages_inputs(rng, b, h, g, d, per, bs, ctx, permute=True))
        out, _, _ = split_kv_model(q, kp, vp, tbl, ctx, sm_count)
        torch.testing.assert_close(out, paged_attention_ref(q, kp, vp, tbl, ctx),
                                   rtol=1e-5, atol=1e-5)

    @pytest.mark.parametrize("d", paged_ops.HEAD_DIMS)
    def test_model_equals_jax_oracle(self, d):
        """Every stream count of the kernel (d / 8 lanes a key), several
        pages a partition, a permuted table, ragged contexts."""
        b, h, g, per, bs = 2, 8, 1, 12, 8
        rng = np.random.default_rng(d)
        arrays = pages_inputs(rng, b, h, g, d, per, bs, [1 + 5 * d % 96, per * bs - 3],
                              permute=True)
        out, pages, n_part = split_kv_model(*map(torch.from_numpy, arrays), sm_count=4)
        assert pages > 1 and n_part > 1
        ref = jax_paged_ref(*map(jnp.asarray, arrays))
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)

    def test_yi_decode_fills_the_card(self):
        """Yi-9B at b = 3 (4 kv-heads x 8 heads, 11 pages of 32): at least
        96 blocks, one page each, against 12 blocks before the split."""
        pages, n_part = partitions(3, 4, 8, 11, H100_SMS)
        assert (pages, n_part) == (1, 11) and 4 * 3 * n_part >= 96
        pages, n_part = partitions(8, 4, 8, 128, H100_SMS)  # 4096 tokens each
        assert pages * 32 == 256 and 4 * 8 * n_part == 512

    @settings(max_examples=200, deadline=None)
    @given(b=st.integers(1, 64), g=st.integers(1, 8), qpg=st.integers(1, 20),
           per=st.integers(1, 600), sms=st.integers(1, 200))
    def test_partitions_cover_every_page_once(self, b, g, qpg, per, sms):
        pages, n_part = partitions(b, g, qpg, per, sms)
        assert 1 <= n_part <= per and (n_part - 1) * pages < per <= n_part * pages
        blocks = b * g * -(-qpg // HEADS_PER_BLOCK) * n_part
        if n_part > 1:  # more pages per partition only to stay near the target
            assert blocks <= 2 * max(BLOCKS_PER_SM * sms, b * g * -(-qpg // HEADS_PER_BLOCK))


def visible(rows, keys, *, causal, window, prefix):
    """dense_ref's mask for absolute q positions ``rows`` and keys."""
    ok = np.ones((len(rows), len(keys)), bool)
    if causal:
        ok &= keys[None] <= rows[:, None]
    if window:
        ok &= (keys[None] > rows[:, None] - window) | (keys[None] < prefix)
    return ok


class TestPrefillTiles:
    @settings(max_examples=150, deadline=None)
    @given(s=st.integers(1, 1400), t=st.integers(1, 1400), causal=st.booleans(),
           window=st.one_of(st.just(0), st.integers(1, 1400)), prefix=st.integers(0, 300),
           tile=st.sampled_from([BF16_TILE, F32_TILE]))
    def test_visited_tiles_hold_every_visible_pair(self, s, t, causal, window, prefix, tile):
        keys = np.arange(t)
        n_kt = -(-t // tile)
        for q_lo in range(0, s, tile):
            tiles = k_tiles(q_lo, s, t, tile, causal=causal, window=window, prefix=prefix)
            assert tiles == sorted(set(tiles)) and all(0 <= j < n_kt for j in tiles)
            vis = visible(np.arange(q_lo, min(q_lo + tile, s)), keys, causal=causal,
                          window=window, prefix=prefix)
            has = np.pad(vis.any(0), (0, n_kt * tile - t)).reshape(n_kt, tile).any(1)
            skipped = sorted(set(range(n_kt)) - set(tiles))
            assert not has[skipped].any(), f"q tile at {q_lo}: a skipped tile holds a pair"

    @pytest.mark.parametrize("kw", [
        dict(causal=True), dict(causal=False),
        dict(causal=True, window=64, prefix=16),
        dict(causal=True, window=1024, prefix=128),  # hymba-1.5b
        dict(causal=False, window=200, prefix=0),
    ])
    @pytest.mark.parametrize("tile", [BF16_TILE, F32_TILE])
    def test_aligned_lengths_equal_pair_schedule(self, kw, tile):
        s = t = 1344  # 21 tiles of 64, 42 of 32
        pi, pj = pair_schedule(s, t, tile, tile, **kw)
        want = {i: [j for ii, j in zip(pi, pj) if ii == i] for i in range(s // tile)}
        for i in range(s // tile):
            assert k_tiles(i * tile, s, t, tile, **kw) == want[i]

    def test_hymba_prefill_skips_the_hidden_middle(self):
        """s = 1328 with window 1024 and a 128-token prefix: the last q tile
        visits the two prefix tiles and the window's tiles, not the ones
        between them."""
        tiles = k_tiles(1280, 1328, 1328, BF16_TILE, causal=True, window=1024, prefix=128)
        assert tiles[:2] == [0, 1] and 2 not in tiles and 3 not in tiles
        assert tiles[-1] == 1327 // BF16_TILE


class FakeKernels:
    """A stand-in for the compiled library's ``<name>_design`` queries."""

    def __init__(self, name, values):
        self.values = values
        setattr(self, f"{name}_design", self.design)

    def design(self, buf, n):
        for i, v in enumerate(self.values[:n]):
            buf[i] = v
        return len(self.values)


DESIGNS = [("paged_attention", paged_ops.DESIGN), ("flash_prefill", flash_ops.DESIGN)]


class TestDesignCheck:
    @pytest.mark.parametrize("name,design", DESIGNS)
    def test_matching_design_passes_once(self, monkeypatch, name, design):
        monkeypatch.setattr(build, "_DESIGN_CHECKED", set())
        build.check_design(name, design, FakeKernels(name, list(design.values())))
        build.check_design(name, design, object())  # checked: the library is not asked again

    @pytest.mark.parametrize("name,design", DESIGNS)
    @pytest.mark.parametrize("drift", ["one value", "one more value", "one value fewer"])
    def test_drifted_design_refuses(self, monkeypatch, name, design, drift):
        monkeypatch.setattr(build, "_DESIGN_CHECKED", set())
        values = list(design.values())
        if drift == "one value":
            values[-1] += 1
        elif drift == "one more value":
            values.append(7)
        else:
            values.pop()
        with pytest.raises(RuntimeError, match="compiled kernel reports"):
            build.check_design(name, design, FakeKernels(name, values))
        assert name not in build._DESIGN_CHECKED
