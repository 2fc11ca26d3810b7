"""The 1F1B pipeline schedule: explicit per-stage instruction streams
and a backward pipeline of its own.

The counterpart of the JAX package's ``parallel/schedule.py``. The tick
streams and the analytics are copied as they are (pure Python). The
pipelined forward with its explicit backward is one
``torch.autograd.Function`` (``_OneFOneB``) whose inputs are the
residual and every stage's leaves:

- its forward walks ``forward_stage_stream`` without an autograd graph
  and keeps only each stage's microbatch inputs, one ``[M, Bm, L, H]``
  set per stage (per member copy), which grows with neither the depth
  nor the tick count (``fwd_residual_shapes``);
- its backward walks ``backward_stage_stream`` (the last stage leads):
  each stage-tick recomputes its slab from the saved input under
  autograd, block checkpoints inside (``pipeline.stage_vjp``), applies
  the cotangent, sends dx to stage s - 1 and adds the leaves'
  gradients into fp32 sums, rounded once to each leaf's dtype when the
  function returns them.

The JAX package masks bubble ticks with a ``lax.cond`` (or computes
and discards them under ``REALHF_TPU_PIPE_MASK=0``); eager code simply
runs no bubble tick, so neither the mask nor its switch exists here.
Rotary tables and segment ids carry no gradient.
"""

import dataclasses
from typing import Dict, List, Optional, Sequence

import torch

from realhf_tpu_torch.ops._build import on_device
from realhf_tpu_torch.parallel.pipeline import (  # noqa: F401
    GPIPE,
    ONE_F_ONE_B,
    SCHEDULES,
    BlockStep,
    PipelineContext,
    Stage,
    aux_cotangents,
    collect_aux,
    hidden_of,
    place_each,
    split_microbatches,
    stage_leaves,
    stage_vjp,
)

# ----------------------------------------------------------------------
# Instruction streams
# ----------------------------------------------------------------------
WARMUP = "warmup"
STEADY = "steady"
COOLDOWN = "cooldown"


@dataclasses.dataclass(frozen=True)
class Tick:
    """One (stage, tick) instruction: op "F"/"B" on a microbatch, or a
    "NOOP" bubble tick."""
    op: str               # "F" | "B" | "NOOP"
    microbatch: int       # -1 for NOOP
    phase: str            # warmup | steady | cooldown


def _phase_of(t: int, n_stages: int, n_microbatches: int) -> str:
    """Global phase of pass-tick t: warm-up until every stage has work,
    steady while all S stages compute, cool-down while the trailing
    stages drain."""
    if t < n_stages - 1:
        return WARMUP
    if t < n_microbatches:
        return STEADY
    return COOLDOWN


def forward_stage_stream(n_stages: int, n_microbatches: int,
                         stage: int) -> List[Tick]:
    """Per-tick instructions of one stage for the forward pass
    (M + S - 1 ticks; stage s runs F(m) at tick m + s)."""
    out = []
    for t in range(n_microbatches + n_stages - 1):
        m = t - stage
        phase = _phase_of(t, n_stages, n_microbatches)
        if 0 <= m < n_microbatches:
            out.append(Tick("F", m, phase))
        else:
            out.append(Tick("NOOP", -1, phase))
    return out


def backward_stage_stream(n_stages: int, n_microbatches: int,
                          stage: int) -> List[Tick]:
    """Backward-pass instructions (M + S - 1 ticks): the mirror
    pipeline, stage s runs B(m) at tick m + (S - 1 - stage), so the
    LAST stage leads and input cotangents move backwards."""
    rev = n_stages - 1 - stage
    out = []
    for t in range(n_microbatches + n_stages - 1):
        m = t - rev
        phase = _phase_of(t, n_stages, n_microbatches)
        if 0 <= m < n_microbatches:
            out.append(Tick("B", m, phase))
        else:
            out.append(Tick("NOOP", -1, phase))
    return out


def train_stage_stream(n_stages: int, n_microbatches: int,
                       stage: int) -> List[Tick]:
    """A train step's stream: the forward pass, then the backward pass
    (2 * (M + S - 1) ticks). The backward cannot start before the last
    forward output's cotangent exists (it comes from the head and loss
    outside the pipeline), so the passes concatenate."""
    return (forward_stage_stream(n_stages, n_microbatches, stage)
            + backward_stage_stream(n_stages, n_microbatches, stage))


def train_schedule(n_stages: int, n_microbatches: int) -> List[List[Tick]]:
    """All stages' train streams (index = stage)."""
    return [train_stage_stream(n_stages, n_microbatches, s)
            for s in range(n_stages)]


# ----------------------------------------------------------------------
# Analytics
# ----------------------------------------------------------------------
def default_microbatches(pp: int, schedule: str = ONE_F_ONE_B) -> int:
    """The engine's default microbatch count: 4 * pp for 1F1B, whose
    saved inputs do not grow with M, 2 * pp for GPipe."""
    return 4 * pp if schedule == ONE_F_ONE_B else 2 * pp


def ticks_per_pass(n_stages: int, n_microbatches: int) -> int:
    return n_microbatches + n_stages - 1


def train_ticks(n_stages: int, n_microbatches: int) -> int:
    """Ticks of one train step (forward + backward pass)."""
    return 2 * ticks_per_pass(n_stages, n_microbatches)


def bubble_fraction(n_stages: int, n_microbatches: int) -> float:
    """The share of a pass's ticks that are bubble: (S-1)/(M+S-1)."""
    return (n_stages - 1) / (n_microbatches + n_stages - 1)


def computed_stage_steps(n_stages: int, n_microbatches: int,
                         schedule: str) -> int:
    """Stage steps the JAX package computes a train step: GPipe's
    lockstep scan every stage every tick, forward and backward, 1F1B
    exactly the 2 * M * S useful ones. The port computes 2 * M * S under
    either schedule (no bubble tick runs), plus the recomputes of its
    checkpoints."""
    t = ticks_per_pass(n_stages, n_microbatches)
    if schedule == ONE_F_ONE_B:
        return 2 * n_microbatches * n_stages
    return 2 * t * n_stages


def train_bubble_factor(pp: int, n_mb: Optional[int] = None,
                        schedule: str = ONE_F_ONE_B) -> float:
    """Wall-clock multiplier over perfect pipeline scaling for one train
    step: (M + pp - 1) / M at the schedule's (default) microbatch
    count."""
    if pp <= 1:
        return 1.0
    m = n_mb or default_microbatches(pp, schedule)
    return (m + pp - 1) / m


# ----------------------------------------------------------------------
# The pipelined forward with an explicit 1F1B backward
# ----------------------------------------------------------------------
#: bytes of the stage inputs the last 1F1B forward kept for its backward
last_saved_bytes = 0


def _dx_key(s: int, m: int, n_mb: int):
    """Where stage s's input cotangent of microbatch m goes: stage
    s - 1's microbatch m."""
    return (s - 1, m)


class _Run:
    """What the 1F1B function needs beyond its tensor inputs."""

    def __init__(self, pipe, stages, mbs, block_step, n_x):
        self.pipe, self.stages, self.mbs = pipe, stages, mbs
        self.block_step, self.n_x = block_step, n_x
        self.leaf_counts = [len(stage_leaves(st)) for st in stages]
        self.aux_keys: List[str] = []


class _OneFOneB(torch.autograd.Function):
    """Inputs: stage 0's members' padded residual copies, then every
    stage's leaves (stage-major, ``stage_leaves`` order). Outputs: the
    last stage's members' hidden states, then the aux values in sorted
    key order."""

    @staticmethod
    def forward(ctx, run: _Run, *args):
        global last_saved_bytes
        S, M = run.pipe.n_stages, run.pipe.n_microbatches
        xs, mbs = args[:run.n_x], run.mbs
        out_dev = run.stages[-1][1][0]
        streams = [forward_stage_stream(S, M, s) for s in range(S)]
        xsave = [[None] * M for _ in range(S)]
        outs, inbox = [None] * M, {}
        aux_tot: Dict = {}
        for t in range(M + S - 1):
            for s in range(S):
                tick = streams[s][t]
                if tick.op != "F" or not mbs.live(tick.microbatch):
                    continue
                m = tick.microbatch
                xin = ([x[mbs.rows(m)] for x in xs] if s == 0
                       else inbox.pop((s, m)))
                xsave[s][m] = xin
                with on_device(run.stages[s][1][0]):
                    ys, aux = run.block_step(s, run.stages[s][0], xin,
                                             *mbs.meta(s, m))
                collect_aux(aux_tot, aux, m, out_dev)
                if s == S - 1:
                    outs[m] = ys
                else:
                    inbox[(s + 1, m)] = place_each(ys, run.stages[s + 1][1])
        last_saved_bytes = sum(x.numel() * x.element_size()
                               for row in xsave for xin in row
                               if xin is not None for x in xin)
        run.aux_keys = sorted(aux_tot)
        ctx.run, ctx.xsave = run, xsave
        hidden = hidden_of(outs, xs[0].shape[0])
        return (*hidden, *[aux_tot[k] for k in run.aux_keys])

    @staticmethod
    def backward(ctx, *grads):
        run, xsave = ctx.run, ctx.xsave
        S, M = run.pipe.n_stages, run.pipe.n_microbatches
        mbs = run.mbs
        g_out = grads[:run.n_x]
        g_aux = dict(zip(run.aux_keys, grads[run.n_x:]))
        streams = [backward_stage_stream(S, M, s) for s in range(S)]
        acc: List[List[Optional[torch.Tensor]]] = [
            [None] * n for n in run.leaf_counts]
        dx0, inbox = [None] * M, {}
        for t in range(M + S - 1):
            # the last stage leads; within a tick the stages are independent
            for s in reversed(range(S)):
                tick = streams[s][t]
                if tick.op != "B" or not mbs.live(tick.microbatch):
                    continue
                m = tick.microbatch
                devs = run.stages[s][1]
                gy = (place_each([g[mbs.rows(m)] for g in g_out], devs)
                      if s == S - 1 else inbox.pop((s, m)))
                ga = aux_cotangents(g_aux, m)
                dxs, dleaves = stage_vjp(run.block_step, s, run.stages[s],
                                         xsave[s][m], mbs.meta(s, m), gy, ga)
                xsave[s][m] = None
                for k, g in enumerate(dleaves):
                    if g is None:
                        continue
                    if acc[s][k] is None:
                        acc[s][k] = g.to(torch.float32)
                    else:
                        acc[s][k].add_(g)
                if s == 0:
                    dx0[m] = dxs
                else:
                    inbox[_dx_key(s, m, M)] = place_each(
                        dxs, run.stages[s - 1][1])
        dx = hidden_of(dx0, g_out[0].shape[0])
        dleaves = [None if a is None else a.to(p.dtype)
                   for st, row in zip(run.stages, acc)
                   for a, p in zip(row, stage_leaves(st))]
        return (None, *dx, *dleaves)


def pipeline_blocks_1f1b(pipe: PipelineContext, stages: Sequence[Stage],
                         xs: Sequence[torch.Tensor], seg_ids: torch.Tensor,
                         cos: torch.Tensor, sin: torch.Tensor,
                         block_step: BlockStep, return_aux: bool = False,
                         mb_rows=None):
    """Run the block stack as a 1F1B-scheduled pipeline -> (hidden,
    aux), with the arguments and results of
    ``pipeline.pipeline_blocks``; differentiable through ``_OneFOneB``.
    The aux values come back per microbatch, as in GPipe."""
    S, M = pipe.n_stages, pipe.n_microbatches
    if len(stages) != S:
        raise ValueError(f"{len(stages)} stages for a {S}-stage pipeline")
    xs, mbs, n_keep = split_microbatches(M, stages, xs, seg_ids, cos, sin,
                                         mb_rows)
    run = _Run(pipe, stages, mbs, block_step, len(xs))
    leaves = [p for st in stages for p in stage_leaves(st)]
    out = _OneFOneB.apply(run, *xs, *leaves)
    hidden = [h[:n_keep] for h in out[:len(xs)]]
    aux = dict(zip(run.aux_keys, out[len(xs):]))
    return hidden, (aux if return_aux else {})


def fwd_residual_shapes(pipe: PipelineContext, n_streams: int, seq_len: int,
                        hidden: int, dtype=torch.bfloat16,
                        n_members: int = 1) -> Dict[str, object]:
    """What the 1F1B function keeps between its forward and backward
    beyond its inputs: each stage's microbatch inputs, ``[S, M, Bm, L,
    H]`` per member copy (``n_members`` = the stage's model members),
    one full-batch boundary activation set per stage, whatever the depth
    and the tick count. Returns the shape and the bytes."""
    S, M = pipe.n_stages, pipe.n_microbatches
    b = n_streams + (-n_streams) % M
    shape = (S, M, b // M, seq_len, hidden)
    n = S * b * seq_len * hidden * n_members
    return dict(shape=shape, n_members=n_members,
                bytes=n * torch.empty((), dtype=dtype).element_size())

