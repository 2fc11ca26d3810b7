"""Single-process experiment runner.

Loads the dataset, walks the dataflow graph level by level over each
batch (amending every MFC's output into the batch), logs per-step time
and token counts, evaluates trained roles on the eval dataset by the
eval frequency, and stops after ``ctl.benchmark_steps`` steps when set.
Models run on the CUDA card unless ``device`` says otherwise.

Saving waits for the checkpoint-IO slice of the port: a configured save
frequency raises, and the final save that the JAX package's runner
always makes is not made.
"""

import time
from typing import Dict, List, Optional, Tuple

from realhf_tpu_torch.api import data as data_api
from realhf_tpu_torch.api.config import ModelInterfaceType
from realhf_tpu_torch.api.dfg import DFG
from realhf_tpu_torch.api.experiment import ExperimentSpec
from realhf_tpu_torch.base import logging, seeding, timeutil
from realhf_tpu_torch.base.device import DeviceLike
from realhf_tpu_torch.system.model_host import ModelHost

logger = logging.getLogger("InlineRunner", "benchmark")


class InlineRunner:

    def __init__(self, spec: ExperimentSpec, device: DeviceLike = None):
        self.spec = spec
        ctl = spec.ctl
        if (ctl.save_freq_epochs, ctl.save_freq_steps,
                ctl.save_freq_secs) != (None, None, None):
            raise NotImplementedError(
                "saving checkpoints is deferred to the checkpoint-IO slice "
                "of the port; unset save_freq_epochs/steps/secs.")
        seeding.set_random_seed(spec.seed)
        import realhf_tpu_torch.datasets  # noqa: F401 - register datasets
        import realhf_tpu_torch.interfaces  # noqa: F401 - register interfaces

        self.dfg = DFG(spec.mfcs)
        self.tokenizer = spec.tokenizer or (
            data_api.load_hf_tokenizer(spec.tokenizer_path)
            if spec.tokenizer_path else None)
        src = self.dfg.sources[0]
        self.dataset = data_api.make_dataset(
            spec.dataset, seed=spec.seed, dp_rank=0, world_size=1,
            tokenizer_or_path=self.tokenizer)
        self.dataloader = data_api.PackedDataLoader(
            self.dataset, batch_size=src.n_seqs, seed=spec.seed)
        self.eval_dataloader = None
        if spec.eval_dataset is not None:
            eval_ds = data_api.make_dataset(
                spec.eval_dataset, seed=spec.seed, dp_rank=0, world_size=1,
                tokenizer_or_path=self.tokenizer)
            self.eval_dataloader = data_api.PackedDataLoader(
                eval_ds, batch_size=src.n_seqs, shuffle=False)
        # the learning-rate schedule spans every step of the run
        total_steps = len(self.dataloader) * spec.total_train_epochs
        self.host = ModelHost(spec, list(spec.models), self.dfg.nodes,
                              self.tokenizer, device=device,
                              total_steps=total_steps)
        self.eval_ctl = timeutil.EpochStepTimeFreqCtl(
            freq_epoch=ctl.eval_freq_epochs, freq_step=ctl.eval_freq_steps)
        self.global_step = 0
        #: the last step's batch with every MFC's outputs merged in
        self.last_batch: Optional[data_api.SequenceSample] = None
        #: seconds and MFC stats of each step run so far
        self.step_secs: List[float] = []
        self.step_stats: List[Dict[str, Dict]] = []
        #: (global step, MFC name, stats) of each evaluation
        self.eval_stats: List[Tuple[int, str, Dict]] = []

    @property
    def models(self):
        return self.host.models

    @property
    def interfaces(self):
        return self.host.interfaces

    def run_step(self, batch: data_api.SequenceSample) -> Dict[str, Dict]:
        """Execute the dataflow graph once over one batch; returns the
        stats dicts of the MFCs that return stats."""
        stats: Dict[str, Dict] = {}
        for level in self.dfg.topological_levels():
            named = [(node.name,
                      batch.select([k for k in node.input_keys
                                    if k in batch.keys]))
                     for node in level]
            outs = self.host.execute_level(named)
            for node, out in zip(level, outs):
                if isinstance(out, data_api.SequenceSample):
                    batch.update_(out)
                elif isinstance(out, dict):
                    stats[node.name] = out
                    if node.log_return_value:
                        logger.info("MFC %s stats: %s", node.name, out)
        self.last_batch = batch
        return stats

    def _maybe_eval(self, epochs: int = 0, steps: int = 0):
        if self.eval_dataloader is None:
            return
        if not self.eval_ctl.check(epochs=epochs, steps=steps):
            return
        for node in self.dfg.nodes:
            if node.interface_type != ModelInterfaceType.TRAIN_STEP:
                continue
            ev = self.interfaces[node.name].evaluate(
                self.models[node.role], self.eval_dataloader)
            if ev:
                self.eval_stats.append((self.global_step, node.name, ev))
                logger.info("Eval %s: %s", node.role, ev)

    def run(self) -> Dict[str, Dict]:
        """Run the configured epochs (or benchmark steps); returns the
        last step's stats."""
        spec = self.spec
        last_stats = {}
        for epoch in range(spec.total_train_epochs):
            for step, batch in enumerate(self.dataloader):
                t0 = time.monotonic()
                last_stats = self.run_step(batch)
                dt = time.monotonic() - t0
                self.step_secs.append(dt)
                self.step_stats.append(last_stats)
                self.global_step += 1
                token_key = next(
                    (k for k in ("packed_input_ids", "packed_prompts")
                     if k in batch.keys),
                    max(batch.keys, key=batch.total_len))
                logger.info("epoch %d step %d (global %d): %.2fs, #tokens %d",
                            epoch, step, self.global_step, dt,
                            batch.total_len(token_key))
                self._maybe_eval(steps=1)
                if (spec.ctl.benchmark_steps is not None
                        and self.global_step >= spec.ctl.benchmark_steps):
                    return last_stats
            self._maybe_eval(epochs=1)
        return last_stats
