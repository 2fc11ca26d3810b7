"""The port's parallelism config and mesh against the JAX package's:
``parse_parallelism`` and ``ParallelismConfig`` field for field, and which
layouts build (every ``dNcCtMpP[s]`` but c with p) and which still
raise."""

import dataclasses

import pytest
import torch

from realhf_tpu.parallel import mesh as jmesh
from realhf_tpu_torch.api.experiment import ParallelismConfig as SpecParallel
from realhf_tpu_torch.parallel import mesh

SPECS = ["d1", "d4t2", "d4p1m2", "d2t2p2", "d1t8s", "c4", "d2c4", "t2c2s",
         "p2g4", "d2t2p2c2g4", "c8", "m4", "s"]


@pytest.mark.parametrize("spec", SPECS)
def test_parse_parallelism_matches_jax(spec):
    got, want = mesh.parse_parallelism(spec), jmesh.parse_parallelism(spec)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert str(got) == str(want)
    assert got.world_size == want.world_size


@pytest.mark.parametrize("bad", ["d2x3", "4d", "d2 t2", ""])
def test_parse_parallelism_refuses_what_jax_refuses(bad):
    for parse in (mesh.parse_parallelism, jmesh.parse_parallelism):
        with pytest.raises(ValueError):
            parse(bad)


def test_config_behaves_like_jax():
    kw = dict(tensor_parallel_size=1, sequence_parallel=True,
              context_parallel_size=2, gen_tp_size=2)
    got, want = mesh.ParallelismConfig(**kw), jmesh.ParallelismConfig(**kw)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert not got.sequence_parallel  # dropped without tensor parallelism
    other = dataclasses.replace(got, gradient_checkpointing=True,
                                pipeline_schedule="gpipe")
    assert got.same_layout(other)
    assert not got.same_layout(dataclasses.replace(
        got, context_parallel_size=4))
    with pytest.raises(ValueError):
        mesh.ParallelismConfig(pipeline_schedule="zb")
    # the experiment spec's ParallelismConfig is this one
    assert SpecParallel is mesh.ParallelismConfig


def test_context_parallel_mesh_builds_over_repeated_devices():
    par = mesh.parse_parallelism("c4")
    m = mesh.make_mesh(par, ["cpu"] * 4)
    assert m.devices == (torch.device("cpu"),) * 4
    assert m.shape == dict(pipe=1, data=1, ctx=4, model=1)
    assert tuple(m.shape) == jmesh.MESH_AXES
    ctx = mesh.MeshContext(None, m, par)
    assert (ctx.dp_size, ctx.tp_size, ctx.pp_size, ctx.cp_size) == (1, 1, 1, 4)
    assert mesh.make_mesh(mesh.ParallelismConfig(), ["cpu"]).devices == (
        torch.device("cpu"),)
    assert mesh.default_devices(4, "cpu") == [torch.device("cpu")] * 4
    with pytest.raises(ValueError, match="needs 4 devices"):
        mesh.make_mesh(par, ["cpu"] * 3)


@pytest.mark.parametrize("spec", ["d2", "t2", "p2", "d2c2", "t2c2", "p2c2"])
def test_other_layouts_of_several_devices_still_raise(spec):
    """d2, t2 and p2 build (the data-, tensor- and pipeline-parallel
    slices), each member in its groups; ctx with d or t builds too, each
    member in its data, context and model groups (``(pipe, data, ctx,
    model)`` order); ctx with p still raises, with the JAX package's
    message."""
    par = mesh.parse_parallelism(spec)
    if "c" not in spec:
        m = mesh.make_mesh(par, ["cpu"] * 2)
        d, t = par.data_parallel_size, par.tensor_parallel_size
        p = par.pipeline_parallel_size
        assert m.shape == dict(pipe=p, data=d, ctx=1, model=t)
        assert [mesh.pipe_index(m, i) for i in range(2)] == (
            [0, 1] if p == 2 else [0, 0])
        assert [mesh.data_group(m, i) for i in range(2)] == (
            [[0, 1], [0, 1]] if d == 2 else [[0], [1]])
        assert [mesh.model_group(m, i) for i in range(2)] == (
            [[0, 1], [0, 1]] if t == 2 else [[0], [1]])
        return
    if par.pipeline_parallel_size > 1:
        with pytest.raises(NotImplementedError, match=(
                r"pipeline parallelism cannot be combined with context "
                r"parallelism \(ring attention\) yet")):
            mesh.make_mesh(par, ["cpu"] * par.world_size)
        return
    m = mesh.make_mesh(par, ["cpu"] * 4)
    d = par.data_parallel_size
    assert m.shape == dict(pipe=1, data=d, ctx=2, model=4 // (2 * d))
    # d2c2: members (g, c) = 0 (0, 0), 1 (0, 1), 2 (1, 0), 3 (1, 1);
    # t2c2: (c, j) = 0 (0, 0), 1 (0, 1), 2 (1, 0), 3 (1, 1)
    assert [mesh.ctx_index(m, i) for i in range(4)] == (
        [0, 1, 0, 1] if d == 2 else [0, 0, 1, 1])
    assert [mesh.ctx_group(m, i) for i in range(4)] == (
        [[0, 1], [0, 1], [2, 3], [2, 3]] if d == 2
        else [[0, 2], [1, 3], [0, 2], [1, 3]])
    assert [mesh.data_group(m, i) for i in range(4)] == (
        [[0, 2], [1, 3], [0, 2], [1, 3]] if d == 2
        else [[0], [1], [2], [3]])
    assert [mesh.model_group(m, i) for i in range(4)] == (
        [[0], [1], [2], [3]] if d == 2 else [[0, 1], [0, 1], [2, 3], [2, 3]])
    assert [mesh.member_at(m, 0, mesh.data_index(m, i),
                           mesh.model_index(m, i), mesh.ctx_index(m, i))
            for i in range(4)] == list(range(4))


def test_default_devices_are_the_cards():
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mesh.default_devices(4)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mesh.make_mesh(mesh.parse_parallelism("c4"))
