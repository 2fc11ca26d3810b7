"""Pipeline parallelism over the members of one process: GPipe.

The counterpart of the JAX package's ``parallel/pipeline.py``. There,
the schedule is one ``lax.scan`` over ticks inside a ``shard_map``
manual over the "pipe" axis, and a ``ppermute`` moves each tick's
activations to the next stage. The port runs one process that drives
every member, so the schedule is a Python loop over the same ticks:
with S stages and M microbatches there are T = M + S - 1 ticks, and
stage s runs microbatch m at tick m + s. A boundary activation moves to
the next stage's members by a copy on the receiving device's current
stream (``Tensor.to``). A bubble tick, a (stage, tick) pair with no
microbatch, computes nothing (eager code has nothing to mask).

A stage is the model members of one pipe index (and one data index):
their block trees, each a contiguous ``n_layers / S`` slab of the
stacked blocks (``models/sharding.py``), and their devices. The
caller's ``block_step(s, trees, xs, segs, coss, sins) -> (ys, aux)``
runs stage s's slab on one microbatch: ``xs`` are the members' copies of
the residual, the metadata lists hold one entry per member, each on the
member's device, and ``aux`` maps each of the slab's aux values (a MoE
model's router sums) to a tensor. The embedding, final norm and heads
run outside the pipeline, as in JAX.

Streams are padded to a multiple of M (``pad_streams``: segment id 0,
so padding rows are masked out of attention and losses); microbatch m is
rows ``[m * Bm, (m + 1) * Bm)``. A caller that splits the streams
itself passes each microbatch's rows (``mb_rows``, contiguous and in
order, some perhaps empty): nothing is padded, and a microbatch with no
rows runs no tick. Either way the aux values come back per microbatch,
keyed ``(m, key)`` and summed over the stages; the caller weighs them
(``microbatch_weights``: each microbatch's real-stream share) and forms
the losses (a mixture-of-experts model's router sums,
``models/transformer.py`` ``_pipeline_router_losses``). The step gets
the microbatch index last.

The backward of ``pipeline_blocks`` is autograd's, the leaves' gradients
summed over the microbatches in fp32 (``_fp32_grad_sums``). With
``remat_tick`` each stage-tick is one ``_TickRemat`` node: its forward
runs the slab without a graph and keeps only the slab's input, its
backward recomputes the slab (block checkpoints inside) and applies the
cotangents. It is an autograd Function rather than a
``torch.utils.checkpoint`` region, because a stage's members may sit on
several cards and a checkpointed region whose saved tensors span cards
would be recomputed by each card's autograd thread
(``models/transformer.py`` ``_block_members``). ``stage_vjp`` is that
recompute; the 1F1B schedule (``parallel/schedule.py``) shares it.
"""

import dataclasses
from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch

from realhf_tpu_torch.ops._build import on_device

GPIPE = "gpipe"
ONE_F_ONE_B = "1f1b"
SCHEDULES = (GPIPE, ONE_F_ONE_B)

Tree = Dict
#: (the stage's model members' block trees, their devices)
Stage = Tuple[List[Tree], List[torch.device]]
BlockStep = Callable[..., Tuple[List[torch.Tensor],
                                Dict[str, torch.Tensor]]]


@dataclasses.dataclass(frozen=True)
class PipelineContext:
    """The pipeline plan of one model: ``schedule`` is "gpipe" (this
    module; autograd's backward; the inference default) or "1f1b"
    (``parallel/schedule.pipeline_blocks_1f1b``; its own backward; the
    training default)."""
    n_stages: int
    n_microbatches: int
    schedule: str = GPIPE

    def __post_init__(self):
        if self.n_stages < 2:
            raise ValueError("A PipelineContext needs >= 2 stages.")
        if self.n_microbatches < 1:
            raise ValueError("A PipelineContext needs >= 1 microbatch.")
        if self.schedule not in SCHEDULES:
            raise ValueError(f"pipeline schedule {self.schedule!r} is not "
                             f"one of {SCHEDULES}")


def microbatch_weights(b_orig: int, bm: int, n_mb: int) -> np.ndarray:
    """Per-microbatch aux weights: each microbatch's REAL stream count
    over the total. ``pad_streams`` appends the padding streams at the
    end, so microbatch m holds ``clip(b_orig - m * bm, 0, bm)`` real
    streams."""
    real = np.clip(b_orig - np.arange(n_mb) * bm, 0, bm)
    return (real / max(b_orig, 1)).astype(np.float32)


def pad_streams(arrs: Sequence[torch.Tensor], n_streams_multiple: int,
                pad_value=0) -> Tuple[List[torch.Tensor], int]:
    """Pad the leading (stream) dim of each tensor to a multiple of
    ``n_streams_multiple`` with ``pad_value`` (segment id 0: every padded
    stream is padding). Returns (tensors, the original stream count)."""
    b = arrs[0].shape[0]
    pad = (-b) % n_streams_multiple
    if pad == 0:
        return list(arrs), b
    return [torch.cat([a, a.new_full((pad, *a.shape[1:]), pad_value)])
            for a in arrs], b


def _to(x: torch.Tensor, device: torch.device) -> torch.Tensor:
    """A boundary copy onto ``device`` (on its current stream)."""
    return x.to(device)


def _next_key(s: int, m: int, n_mb: int):
    """Where stage s's output of microbatch m goes: stage s + 1's
    microbatch m."""
    return (s + 1, m)


def place(x: torch.Tensor, devices: Sequence[torch.device]
          ) -> List[torch.Tensor]:
    """``x`` on every device of a stage, copied once per distinct
    device."""
    on = {}
    for d in devices:
        if d not in on:
            on[d] = _to(x, d)
    return [on[d] for d in devices]


def place_each(xs: Sequence[torch.Tensor], devices: Sequence[torch.device]
               ) -> List[torch.Tensor]:
    """Member j's tensor onto the next stage's member j."""
    return [_to(x, d) for x, d in zip(xs, devices)]


class Microbatches:
    """Padded per-token metadata (segment ids and rotary tables) split
    into microbatches of ``bm`` rows, or along ``bounds`` ((start, stop)
    of each), each placed on a stage's devices when first asked for."""

    def __init__(self, seg, cos, sin, n_mb: int, stages: Sequence[Stage],
                 bounds=None):
        self.bm = seg.shape[0] // n_mb
        self.bounds = bounds or [(m * self.bm, (m + 1) * self.bm)
                                 for m in range(n_mb)]
        self.parts = (seg, cos, sin)
        self.stages = stages
        self._placed = {}

    def rows(self, m: int) -> slice:
        return slice(*self.bounds[m])

    def live(self, m: int) -> bool:
        """Whether microbatch m has rows."""
        return self.bounds[m][1] > self.bounds[m][0]

    def meta(self, s: int, m: int):
        """(segs, coss, sins, m) of microbatch m: the metadata one per
        member of stage s, on its device, and the index. A row slice that
        does not start on a 16-byte boundary (the kernels' loads of the
        segment ids) is copied."""
        key = (s, m)
        if key not in self._placed:
            devs = self.stages[s][1]
            self._placed[key] = (*(place(_aligned(a[self.rows(m)]), devs)
                                   for a in self.parts), m)
        return self._placed[key]


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a copy of it when its data does not start on a 16-byte
    boundary."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def split_microbatches(n_mb: int, stages: Sequence[Stage], xs, seg_ids,
                       cos, sin, mb_rows=None):
    """-> (xs, ``Microbatches``, the stream count to keep): padded to a
    multiple of ``n_mb``, or along ``mb_rows`` unpadded."""
    if mb_rows is not None:
        return (list(xs), Microbatches(seg_ids, cos, sin, n_mb, stages,
                                       mb_rows), seg_ids.shape[0])
    padded, b_orig = pad_streams([*xs, seg_ids, cos, sin], n_mb)
    xs, (seg_ids, cos, sin) = padded[:len(xs)], padded[len(xs):]
    return xs, Microbatches(seg_ids, cos, sin, n_mb, stages), b_orig


def collect_aux(total: Dict, aux: Dict[str, torch.Tensor], m: int,
                device: torch.device):
    """One stage-tick's aux values into ``total`` as ``(m, key)``, on
    ``device``, added over the stages."""
    for k in sorted(aux):
        v = _to(aux[k], device)
        total[(m, k)] = total[(m, k)] + v if (m, k) in total else v


def aux_cotangents(g_aux: Dict, m: int) -> Dict[str, torch.Tensor]:
    """The cotangents of microbatch m's stage-tick aux values from those
    of the pipeline's aux outputs (``collect_aux``'s inverse)."""
    return {k[1]: v for k, v in g_aux.items() if k[0] == m}


def hidden_of(outs, n_keep: int):
    """The last stage's outputs of the microbatches that ran, joined
    member by member and cut to ``n_keep`` streams."""
    ran = [o for o in outs if o is not None]
    return [torch.cat([o[j] for o in ran])[:n_keep]
            for j in range(len(ran[0]))]


def block_leaves(tree: Tree) -> List[torch.Tensor]:
    """A member tree's block leaves in sorted-key order."""
    out = []

    def walk(t):
        for k in sorted(t):
            if isinstance(t[k], dict):
                walk(t[k])
            else:
                out.append(t[k])

    walk(tree["blocks"])
    return out


def stage_leaves(stage: Stage) -> List[torch.Tensor]:
    """Every member's block leaves, member-major."""
    return [p for tr in stage[0] for p in block_leaves(tr)]


def _with_blocks(tree: Tree, leaves) -> Tree:
    """``{"blocks": ...}`` of ``tree``'s structure holding ``leaves``."""
    it = iter(leaves)

    def fill(t):
        return {k: (fill(t[k]) if isinstance(t[k], dict) else next(it))
                for k in sorted(t)}

    return {"blocks": fill(tree["blocks"])}


def stage_vjp(block_step: BlockStep, s: int, stage: Stage, xin, meta, gys,
              gaux: Dict[str, torch.Tensor]):
    """Stage s's slab recomputed on one microbatch's saved inputs
    ``xin`` under autograd (block checkpoints inside), with the
    cotangents ``gys`` of its outputs and ``gaux`` of its aux values
    applied -> (the inputs' cotangents, the cotangents of the stage's
    leaves in ``stage_leaves`` order, None for a leaf the slab does not
    reach). Runs on stage s's first device."""
    trees, devs = stage
    with on_device(devs[0]), torch.enable_grad():
        xs = [x.detach().requires_grad_() for x in xin]
        leaves = [p.detach().requires_grad_() for p in stage_leaves(stage)]
        per = len(leaves) // len(trees)
        dtrees = [_with_blocks(tr, leaves[j * per:(j + 1) * per])
                  for j, tr in enumerate(trees)]
        ys, aux = block_step(s, dtrees, xs, *meta)
        outs, cots = list(ys), list(gys)
        for k in sorted(aux):
            if aux[k].requires_grad:
                outs.append(aux[k])
                cots.append(_to(gaux[k], aux[k].device))
        got = torch.autograd.grad(outs, xs + leaves, cots, allow_unused=True)
    return list(got[:len(xs)]), list(got[len(xs):])


class _TickState:
    """What one remat tick's node needs beyond its tensor inputs."""

    def __init__(self, block_step, s, stage, meta, n_x):
        self.block_step, self.s, self.stage = block_step, s, stage
        self.meta, self.n_x = meta, n_x
        self.aux_keys: List[str] = []


class _TickRemat(torch.autograd.Function):
    """One stage-tick of the GPipe forward, checkpointed as a whole:
    inputs are the members' residual copies and the stage's leaves;
    outputs the members' outputs, then the aux values in sorted key
    order."""

    @staticmethod
    def forward(ctx, st: _TickState, *args):
        xin = list(args[:st.n_x])
        ys, aux = st.block_step(st.s, st.stage[0], xin, *st.meta)
        st.aux_keys = sorted(aux)
        ctx.st = st
        ctx.save_for_backward(*xin)
        return (*ys, *[aux[k] for k in st.aux_keys])

    @staticmethod
    def backward(ctx, *grads):
        st = ctx.st
        gys = grads[:st.n_x]
        gaux = dict(zip(st.aux_keys, grads[st.n_x:]))
        dxs, dleaves = stage_vjp(st.block_step, st.s, st.stage,
                                 ctx.saved_tensors, st.meta, gys, gaux)
        return (None, *dxs, *dleaves)


#: bytes of the stage-tick inputs the last ``remat_tick`` GPipe forward
#: kept for its backward (what its ``_TickRemat`` nodes save)
last_saved_bytes = 0


def _fp32_grad_sums(stage: Stage) -> Stage:
    """``stage`` with each trained block leaf of a lower precision in an
    fp32 copy under autograd: every microbatch's gradient of it adds up
    in fp32, and the copy's backward rounds the sum to the leaf's dtype
    once, as the 1F1B backward does. Every use casts a weight to the
    compute dtype, so the forward's values do not change."""
    trees, devs = stage
    return [_with_blocks(tr, [
        p.float() if p.requires_grad and p.dtype != torch.float32 else p
        for p in block_leaves(tr)]) for tr in trees], devs


def _tick(block_step, s, stage, xin, meta, remat_tick):
    global last_saved_bytes
    if not remat_tick:
        return block_step(s, stage[0], xin, *meta)
    last_saved_bytes += sum(x.numel() * x.element_size() for x in xin)
    st = _TickState(block_step, s, stage, meta, len(xin))
    out = _TickRemat.apply(st, *xin, *stage_leaves(stage))
    return list(out[:len(xin)]), dict(zip(st.aux_keys, out[len(xin):]))


def pipeline_blocks(pipe: PipelineContext, stages: Sequence[Stage],
                    xs: Sequence[torch.Tensor], seg_ids: torch.Tensor,
                    cos: torch.Tensor, sin: torch.Tensor,
                    block_step: BlockStep, return_aux: bool = False,
                    remat_tick: bool = False, mb_rows=None):
    """Run the block stack as a GPipe pipeline over ``stages`` ->
    (the last stage's members' hidden states [B, L, H], aux).

    ``xs`` are stage 0's members' copies of the residual after the
    embedding ([B, L, H], or each member's token shard under sequence
    parallelism; each on its member's device); ``seg_ids`` [B, L],
    ``cos``/``sin`` [B, L, hd/2] lie on stage 0's first device.
    ``remat_tick`` checkpoints each stage-tick's slab as a whole
    (``_TickRemat``). ``mb_rows``: the caller's microbatches (the
    module note)."""
    global last_saved_bytes
    S, M = pipe.n_stages, pipe.n_microbatches
    if len(stages) != S:
        raise ValueError(f"{len(stages)} stages for a {S}-stage pipeline")
    if torch.is_grad_enabled():
        stages = [_fp32_grad_sums(st) for st in stages]
    xs, mbs, n_keep = split_microbatches(M, stages, xs, seg_ids, cos, sin,
                                         mb_rows)
    if remat_tick:
        last_saved_bytes = 0
    out_dev = stages[-1][1][0]
    outs = [None] * M
    inbox = {}
    aux_tot: Dict = {}
    for t in range(M + S - 1):
        for s in range(S):
            m = t - s
            if not 0 <= m < M or not mbs.live(m):
                continue  # a bubble tick computes nothing
            xin = ([x[mbs.rows(m)] for x in xs] if s == 0
                   else inbox.pop((s, m)))
            with on_device(stages[s][1][0]):
                ys, aux = _tick(block_step, s, stages[s], xin,
                                mbs.meta(s, m), remat_tick)
            collect_aux(aux_tot, aux, m, out_dev)
            if s == S - 1:
                outs[m] = ys
            else:
                inbox[_next_key(s, m, M)] = place_each(ys, stages[s + 1][1])
    return hidden_of(outs, n_keep), (aux_tot if return_aux else {})
