"""Device meshes and the per-model parallelism context.

The counterpart of the JAX package's ``parallel/mesh.py``. There, each
model owns a ``jax.sharding.Mesh`` over a slice of the device fleet and
GSPMD derives the collectives. The port runs one process that drives
every device itself, so a mesh here is a plain object: the model's
devices, flat in the axis order ``(pipe, data, ctx, model)``, and the
size of each axis. It is not a ``torch.distributed`` ``DeviceMesh``.

A device may appear more than once: ``[cuda:0] * 4`` puts four
context-parallel members on one card, and ``[cpu] * 4`` four on the
CPU. That is the port's counterpart of the virtual CPU devices the JAX
tests run on.

Member ``i`` of a ``dNcCtMpP`` layout has pipe index ``i // (d * c *
t)``, data index ``(i // (c * t)) % d``, context index ``(i // t) % c``
and model index ``i % t``. The members of one pipe index form a stage,
which holds a contiguous ``n_layers / p`` slab of the blocks
(``parallel/pipeline.py``); within a stage, the members of one (data,
context) index form a model group (they split each weight, as
``models/sharding.py`` says), the members of one (data, model) index a
context group (each holds a contiguous ``1/c`` of every stream's tokens,
and they meet in ring attention, ``ops/ring_attention_fused.py``), and
the members of one (context, model) index a data group (they hold
disjoint streams and sum their gradients). With sequence parallelism
(``s``, at t > 1) the residual stream of a model group is split once
more along its tokens over the model members (``models/transformer.py``).

Context parallelism together with pipeline parallelism raises, with the
JAX package's message (its engine refuses the pair too). ``gen_tp_size``
(``g``) is the model degree of the decode view (``engine/engine.py``
``Engine.decode_engine``); it must divide the layout's device count.
"""

import dataclasses
import re
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from realhf_tpu_torch.api.config import ModelName
from realhf_tpu_torch.base.device import DeviceLike, resolve_device

PIPE_AXIS = "pipe"
DATA_AXIS = "data"
CTX_AXIS = "ctx"  # context parallelism (ring attention over sequence)
MODEL_AXIS = "model"
MESH_AXES = (PIPE_AXIS, DATA_AXIS, CTX_AXIS, MODEL_AXIS)


@dataclasses.dataclass(frozen=True)
class ParallelismConfig:
    """Parallelism degrees of one model, as in the JAX package."""
    data_parallel_size: int = 1
    tensor_parallel_size: int = 1
    pipeline_parallel_size: int = 1
    #: ring attention over the sequence dim
    context_parallel_size: int = 1
    sequence_parallel: bool = False
    gradient_checkpointing: bool = False
    #: pipeline microbatch count when pipeline_parallel_size > 1 (0 =
    #: auto); not part of the weight layout (same_layout ignores it)
    pipeline_microbatches: int = 0
    #: "1f1b" or "gpipe"; not part of the weight layout
    pipeline_schedule: str = "1f1b"
    #: tensor-parallel degree of the decode view (0 = inherit
    #: tensor_parallel_size); not part of the weight layout
    gen_tp_size: int = 0

    def __post_init__(self):
        if self.sequence_parallel and self.tensor_parallel_size == 1:
            object.__setattr__(self, "sequence_parallel", False)
        if self.pipeline_schedule not in ("gpipe", "1f1b"):
            raise ValueError(
                f"pipeline_schedule must be 'gpipe' or '1f1b', got "
                f"{self.pipeline_schedule!r}")

    @property
    def world_size(self) -> int:
        return (self.data_parallel_size * self.tensor_parallel_size *
                self.pipeline_parallel_size * self.context_parallel_size)

    def same_layout(self, other: "ParallelismConfig") -> bool:
        """Same device-placement layout (ignores flags like
        gradient_checkpointing that do not affect weight placement)."""
        return (self.data_parallel_size == other.data_parallel_size
                and self.tensor_parallel_size == other.tensor_parallel_size
                and self.pipeline_parallel_size == other.pipeline_parallel_size
                and self.context_parallel_size == other.context_parallel_size
                and self.sequence_parallel == other.sequence_parallel)

    def __str__(self):
        s = (f"d{self.data_parallel_size}t{self.tensor_parallel_size}"
             f"p{self.pipeline_parallel_size}")
        if self.context_parallel_size > 1:
            s += f"c{self.context_parallel_size}"
        if self.sequence_parallel:
            s += "s"
        if self.gen_tp_size:
            s += f"g{self.gen_tp_size}"
        return s


def parse_parallelism(name: str) -> ParallelismConfig:
    """Parse the ``d$Nt$Tp$Pc$Cg$G`` allocation shorthand, e.g. "d4t2",
    "d2t2p2" or "c4": d = data, t = tensor (m also accepted), p =
    pipeline, c = context, g = decode tensor-parallel degree; a trailing
    "s" enables sequence parallelism. Axes may come in any order."""
    s = name.strip()
    tokens = re.findall(r"([dtmpcg])(\d+)|(s)(?!\d)", s)
    consumed = "".join(t[0] + t[1] + t[2] for t in tokens)
    sizes = {"d": 1, "t": 1, "p": 1, "c": 1, "g": 0}
    seq_par = False
    for axis, num, sp in tokens:
        if sp:
            seq_par = True
            continue
        sizes["t" if axis == "m" else axis] = int(num)
    if consumed != s or not tokens:
        raise ValueError(f"Cannot parse parallelism spec `{name}`; "
                         "expected e.g. d4t2, d4p1m2, d2t2p1, d1t8s "
                         "(any axis order; m is an alias for t).")
    return ParallelismConfig(
        data_parallel_size=sizes["d"],
        tensor_parallel_size=sizes["t"],
        pipeline_parallel_size=sizes["p"],
        context_parallel_size=sizes["c"],
        sequence_parallel=seq_par,
        gen_tp_size=sizes["g"])


def default_devices(n: int, device: DeviceLike = None) -> List[torch.device]:
    """The devices of a layout of ``n`` when the caller names none:
    ``cuda:0 .. cuda:n-1`` (raises when the machine has fewer cards), or
    ``n`` times the CPU when ``device`` asks for the CPU."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return [dev] * n
    have = torch.cuda.device_count()
    if have < n:
        raise RuntimeError(
            f"A layout of {n} devices needs {n} CUDA cards, this machine "
            f"has {have}; pass an explicit device list (e.g. "
            f"['cuda:0'] * {n}) to place several members on one card.")
    return [torch.device("cuda", i) for i in range(n)]


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A model's devices, flat in ``MESH_AXES`` order, and the size of
    each axis. Entries may repeat (several members on one device)."""
    devices: Tuple[torch.device, ...]
    shape: Dict[str, int]


def _check_device(d) -> torch.device:
    dev = resolve_device(d)
    if dev.type == "cuda":
        dev = torch.device("cuda", dev.index if dev.index is not None
                           else torch.cuda.current_device())
        if dev.index >= torch.cuda.device_count():
            raise RuntimeError(f"{dev} does not exist on this machine "
                               f"({torch.cuda.device_count()} cards).")
    return dev


def check_layout(parallel: ParallelismConfig):
    """Raise ``NotImplementedError`` for a layout this port does not
    build (context with pipeline parallelism, as the JAX package), and
    ``ValueError`` for a decode-view degree that does not divide the
    layout."""
    if (parallel.context_parallel_size > 1
            and parallel.pipeline_parallel_size > 1):
        raise NotImplementedError(
            "pipeline parallelism cannot be combined with context "
            "parallelism (ring attention) yet; use pp x tp x dp or "
            "cp x tp x dp.")
    g = parallel.gen_tp_size
    if g and parallel.world_size % g:
        raise ValueError(f"Layout {parallel}: gen_tp_size={g} does not "
                         f"divide its {parallel.world_size} devices.")


def make_mesh(parallel: ParallelismConfig,
              devices: Optional[Sequence[DeviceLike]] = None) -> Mesh:
    """The mesh of one model over ``devices`` (default:
    ``default_devices(world_size)``). Builds every layout but those
    ``check_layout`` raises for."""
    check_layout(parallel)
    n = parallel.world_size
    devices = (default_devices(n) if devices is None
               else [_check_device(d) for d in devices])
    if len(devices) != n:
        raise ValueError(f"Parallelism {parallel} needs {n} devices, got "
                         f"{len(devices)}.")
    kinds = {d.type for d in devices}
    if len(kinds) > 1:
        raise ValueError(f"A mesh lies on one kind of device, got {devices}.")
    shape = dict(zip(MESH_AXES, (parallel.pipeline_parallel_size,
                                 parallel.data_parallel_size,
                                 parallel.context_parallel_size,
                                 parallel.tensor_parallel_size)))
    return Mesh(tuple(devices), shape)


def pipe_index(mesh: Mesh, i: int) -> int:
    """Member ``i``'s stage."""
    return i // (mesh.shape[DATA_AXIS] * mesh.shape[CTX_AXIS]
                 * mesh.shape[MODEL_AXIS])


def data_index(mesh: Mesh, i: int) -> int:
    """Member ``i``'s index along the data axis."""
    return (i // (mesh.shape[CTX_AXIS] * mesh.shape[MODEL_AXIS])
            ) % mesh.shape[DATA_AXIS]


def ctx_index(mesh: Mesh, i: int) -> int:
    """Member ``i``'s index along the context axis: its token shard."""
    return (i // mesh.shape[MODEL_AXIS]) % mesh.shape[CTX_AXIS]


def model_index(mesh: Mesh, i: int) -> int:
    """Member ``i``'s index along the model axis."""
    return i % mesh.shape[MODEL_AXIS]


def member_at(mesh: Mesh, s: int, g: int, j: int, c: int = 0) -> int:
    """The member at stage ``s``, data index ``g``, context index ``c``,
    model index ``j``."""
    return (((s * mesh.shape[DATA_AXIS] + g) * mesh.shape[CTX_AXIS] + c)
            * mesh.shape[MODEL_AXIS] + j)


def model_group(mesh: Mesh, i: int) -> List[int]:
    """The members that split the weights with member ``i`` (its stage,
    data and context index, every model index), in model order."""
    t = mesh.shape[MODEL_AXIS]
    base = i - model_index(mesh, i)
    return list(range(base, base + t))


def ctx_group(mesh: Mesh, i: int) -> List[int]:
    """The members whose token shards make up member ``i``'s streams
    (its stage, data and model index, every context index), in ring
    order."""
    s, g, j = pipe_index(mesh, i), data_index(mesh, i), model_index(mesh, i)
    return [member_at(mesh, s, g, j, c) for c in range(mesh.shape[CTX_AXIS])]


def data_group(mesh: Mesh, i: int) -> List[int]:
    """The members that hold member ``i``'s weight shard and token shard
    of other streams (its stage, context and model index, every data
    index), in data order."""
    s, c, j = pipe_index(mesh, i), ctx_index(mesh, i), model_index(mesh, i)
    return [member_at(mesh, s, g, j, c) for g in range(mesh.shape[DATA_AXIS])]


def holders(mesh: Mesh, i: int, split: bool, staged: bool,
            data_split: bool = False) -> List[int]:
    """The members that hold the same values of a leaf as member ``i``:
    a leaf split over the model members (``split``) only on its model
    index, a block leaf (``staged``) only in its stage, an
    expert-parallel leaf (``data_split``) only on its data index;
    replicated over everything else (data and context indices
    included)."""
    return [k for k in range(len(mesh.devices))
            if (not split or model_index(mesh, k) == model_index(mesh, i))
            and (not staged or pipe_index(mesh, k) == pipe_index(mesh, i))
            and (not data_split
                 or data_index(mesh, k) == data_index(mesh, i))]


@dataclasses.dataclass
class MeshContext:
    """Everything parallelism-related about one model instance."""
    model_name: ModelName
    mesh: Mesh
    parallel: ParallelismConfig

    @property
    def dp_size(self) -> int:
        return self.parallel.data_parallel_size

    @property
    def tp_size(self) -> int:
        return self.parallel.tensor_parallel_size

    @property
    def pp_size(self) -> int:
        return self.parallel.pipeline_parallel_size

    @property
    def cp_size(self) -> int:
        return self.parallel.context_parallel_size
