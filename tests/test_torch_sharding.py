"""The port's placement rules (``repro_torch.launch.shardings``) against the
reference's on the stub meshes of ``tests/test_shardings.py``: every param
leaf of all 11 configs at full size, in both modes, with and without the
model axis folded into DP; every decode-state field; ``batch_spec``.  A
spec is a tuple equal element for element to the reference's
``PartitionSpec``.  The param trees are the reference's shapes
(``jax.eval_shape``, never allocated) carried over as meta tensors, and
the port's own smoke trees are checked to hold the same leaves.  Then
``shard_tensor`` / ``shard_params`` against the specs they follow.
"""
import functools

import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCHS, get_config, get_smoke_config
from repro.launch import shardings as jax_shardings
from repro.models.registry import build_model as jax_build_model
from repro_torch import bridge
from repro_torch.configs import get_config as pt_config
from repro_torch.configs import get_smoke_config as pt_smoke_config
from repro_torch.launch import shardings
from repro_torch.launch.mesh import Mesh
from repro_torch.models.registry import build_model

MESHES = {"2d": {"data": 16, "model": 16}, "multipod": {"pod": 2, "data": 16, "model": 16}}


class _Stub:
    def __init__(self, shape):
        self.shape = shape


def _jax_names(path):
    return jax_shardings._path_names(path)


@functools.lru_cache(maxsize=None)
def _jax_param_shapes(arch, smoke=False):
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    model = jax_build_model(cfg)
    return jax.eval_shape(lambda: model.init_params(jax.random.PRNGKey(0)))


def _leaves(tree):
    return jax.tree_util.tree_flatten_with_path(tree)[0]


def _as_meta(tree):
    """The reference's shape tree as the port's: a dict tree of meta tensors."""
    if isinstance(tree, dict):
        return {k: _as_meta(v) for k, v in tree.items()}
    return torch.empty(tree.shape, device="meta")


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("fold", [False, True])
@pytest.mark.parametrize("mode", ["serve", "train"])
@pytest.mark.parametrize("arch", list(ARCHS))
def test_param_specs_equal_the_reference(arch, mode, fold, mesh_name):
    mesh = _Stub(MESHES[mesh_name])
    shapes = _jax_param_shapes(arch)
    got = shardings.param_sharding(_as_meta(shapes), mesh, mode=mode, fold_model=fold)
    n = 0
    for path, leaf in _leaves(shapes):
        names = _jax_names(path)
        want = jax_shardings.logical_spec(names, tuple(leaf.shape), mesh, mode=mode,
                                          fold_model=fold)
        node = got
        for k in names:
            node = node[k]
        assert node == tuple(want), f"{arch} {'/'.join(names)} {leaf.shape}"
        n += 1
    assert n > 0


@pytest.mark.parametrize("arch", list(ARCHS))
def test_port_trees_hold_the_reference_leaves(arch):
    """The rules see the same leaves in the port's own params: the smoke
    trees' paths and shapes are the reference's."""
    pt = build_model(pt_smoke_config(arch), device="cpu").init_params(0)
    want = {tuple(_jax_names(p)): tuple(x.shape)
            for p, x in _leaves(_jax_param_shapes(arch, smoke=True))}
    got = {}
    shardings.tree_map_with_path(lambda names, x: got.__setitem__(tuple(names),
                                                                   tuple(x.shape)), pt)
    assert got == want


@pytest.mark.parametrize("batch", [1, 2, 32, 256])
@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", list(ARCHS))
def test_decode_state_specs_equal_the_reference(monkeypatch, arch, mesh_name, batch):
    mesh = _Stub(MESHES[mesh_name])
    monkeypatch.setattr(jax_shardings, "NamedSharding", lambda m, spec: spec)
    want = jax_shardings.decode_state_sharding(
        jax_build_model(get_config(arch)).decode_state_shape(batch, 32_768), mesh)
    got = shardings.decode_state_sharding(
        build_model(pt_config(arch), device="cpu").decode_state_shape(batch, 32_768), mesh)
    want = {name: tuple(getattr(want, name)) for name in got}
    assert got == want
    assert "context_lens" in got


@pytest.mark.parametrize("fold", [False, True])
@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("batch", [1, 2, 32, 256])
def test_batch_spec_equals_the_reference(batch, mesh_name, fold):
    mesh = _Stub(MESHES[mesh_name])
    assert shardings.batch_spec(mesh, batch, fold_model=fold) == \
        tuple(jax_shardings.batch_spec(mesh, batch, fold_model=fold))


class TestShardTensor:
    @pytest.mark.parametrize("spec", [(None, "model"), ("data", None), (("data", "model"), None),
                                      ("model", "data"), (None, None)])
    def test_slices_tile_the_tensor(self, spec):
        shape = {"data": 2, "model": 3}
        x = torch.arange(12 * 6, dtype=torch.float32).reshape(12, 6)
        parts = {r: shardings.shard_tensor(x, spec, Mesh.view(shape, r)) for r in range(6)}
        rebuilt = torch.zeros_like(x)
        for r, part in parts.items():
            coords = Mesh.view(shape, r).coords
            index = []
            for dim, entry in enumerate(spec):
                if entry is None:
                    index.append(slice(None))
                    continue
                axes = (entry,) if isinstance(entry, str) else entry
                i = 0
                for a in axes:
                    i = i * shape[a] + coords[a]
                n = x.shape[dim] // int(np.prod([shape[a] for a in axes]))
                index.append(slice(i * n, (i + 1) * n))
            assert torch.equal(part, x[tuple(index)])
            rebuilt[tuple(index)] = part
            if any(e is not None for e in spec):
                assert part.untyped_storage().data_ptr() != x.untyped_storage().data_ptr()
        assert torch.equal(rebuilt, x)

    def test_mesh_view_is_row_major(self):
        assert Mesh.view({"data": 2, "model": 4}, 6).coords == {"data": 1, "model": 2}
        assert Mesh.view({"pod": 2, "data": 2, "model": 2}, 5).coords == \
            {"pod": 1, "data": 0, "model": 1}

    def test_params_from_jax_gives_each_rank_its_slice(self):
        """``bridge.params_from_jax(..., mesh=...)``: the yi smoke params at
        TP 4, rank 2: q's columns 2/4, o's rows 2/4, the vocab rows 2/4,
        norms whole."""
        jp = jax.tree.map(np.asarray, jax_build_model(get_smoke_config("yi-9b")).init_params(
            jax.random.PRNGKey(0)))
        mesh = Mesh.view({"data": 1, "model": 4}, 2)
        got = bridge.params_from_jax(jp, mesh=mesh)
        full = bridge.params_from_jax(jp)
        q, o = full["layers"]["attn"]["q"]["w"], full["layers"]["attn"]["o"]["w"]
        assert torch.equal(got["layers"]["attn"]["q"]["w"], q[:, :, 32:48])
        assert torch.equal(got["layers"]["attn"]["o"]["w"], o[:, 32:48])
        assert torch.equal(got["embed"]["table"], full["embed"]["table"][256:384])
        assert torch.equal(got["layers"]["attn_norm"]["scale"],
                           full["layers"]["attn_norm"]["scale"])
