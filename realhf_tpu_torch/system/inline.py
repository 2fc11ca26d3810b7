"""Single-process experiment runner.

Loads the dataset, walks the dataflow graph level by level over each
batch (amending every MFC's output into the batch), logs per-step time
and token counts, evaluates trained roles on the eval dataset by the
eval frequency, and stops after ``ctl.benchmark_steps`` steps when set.
Models run on the CUDA card unless ``device`` says otherwise;
``role_devices`` places the members of a role's layout and ``devices``
lists the runner's devices, which per-MFC allocations draw their
replicas' members from (``ModelHost``).

Saving and resuming follow the JAX package's runner: every trained role
is saved (weights and optimizer state, under ``run_save_path()/role``)
at the save frequency and once more at the end of ``run``. With a
``recover_mode`` other than "disabled" each save also dumps the recover
info; "resume" continues from it: each role loads from its last save
with its optimizer state, the step counters come back, and the data ids
already consumed in the interrupted epoch are skipped.
"""

import os
import time
from typing import Dict, List, Optional, Sequence, Tuple

from realhf_tpu_torch.api import data as data_api
from realhf_tpu_torch.api.config import ModelInterfaceType
from realhf_tpu_torch.api.dfg import DFG
from realhf_tpu_torch.api.experiment import ExperimentSpec
from realhf_tpu_torch.base import (
    constants,
    logging,
    recover,
    seeding,
    timeutil,
)
from realhf_tpu_torch.base.device import DeviceLike
from realhf_tpu_torch.system.model_host import ModelHost

logger = logging.getLogger("InlineRunner", "benchmark")


class InlineRunner:

    def __init__(self, spec: ExperimentSpec, device: DeviceLike = None,
                 role_devices: Optional[Dict[str, Sequence[DeviceLike]]]
                 = None, recover_mode: str = "disabled",
                 devices: Optional[Sequence[DeviceLike]] = None):
        self.spec = spec
        constants.set_experiment_trial_names(spec.experiment_name,
                                             spec.trial_name)
        seeding.set_random_seed(spec.seed)

        self.recover_mode = recover_mode
        self._recover_info = None
        if recover_mode == "resume":
            self._recover_info = recover.load_safe()
        if self._recover_info is not None:
            logger.info("Resuming from recover info (schema v%d): %s",
                        self._recover_info.version,
                        self._recover_info.recover_start)
            for role, mspec in spec.models.items():
                ckpt = os.path.join(constants.run_save_path(), role)
                if os.path.exists(os.path.join(ckpt, "config.json")):
                    mspec.path = ckpt
                    mspec.random_init_config = None
                    mspec.restore_optimizer_state = True
                    logger.info("Recovered %s from %s", role, ckpt)

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
                              total_steps=total_steps,
                              role_devices=role_devices, devices=devices)
        ctl = spec.ctl
        self.save_ctl = timeutil.EpochStepTimeFreqCtl(
            freq_epoch=ctl.save_freq_epochs, freq_step=ctl.save_freq_steps,
            freq_sec=ctl.save_freq_secs)
        self.eval_ctl = timeutil.EpochStepTimeFreqCtl(
            freq_epoch=ctl.eval_freq_epochs, freq_step=ctl.eval_freq_steps)
        self.global_step = 0
        self._start_epoch = 0
        self._start_epoch_step = 0
        self._ids_to_skip = set()
        if self._recover_info is not None:
            info = self._recover_info
            self.global_step = info.last_step_info.global_step
            self._start_epoch = info.recover_start.epoch
            self._ids_to_skip = set(info.hash_vals_to_ignore)
            dl = info.dataloader_state or {}
            self._start_epoch_step = int(dl.get("epoch_step", 0))
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

    @property
    def replicas(self):
        return self.host.replicas

    @property
    def replica_mgr(self):
        return self.host.replica_mgr

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

    def _maybe_save(self, epochs: int = 0, steps: int = 0, force=False):
        if not force and not self.save_ctl.check(epochs=epochs, steps=steps):
            return
        for node in self.dfg.nodes:
            if node.interface_type == ModelInterfaceType.TRAIN_STEP:
                self.host.save_role(node.role, node.name)
        # recover info is valid only beside the checkpoint it describes,
        # so it is dumped here and never on unsaved steps
        if self.recover_mode != "disabled":
            recover.dump(recover.RecoverInfo(
                recover_start=recover.StepInfo(
                    epoch=self._cur_epoch,
                    epoch_step=self._cur_epoch_step + 1,
                    global_step=self.global_step),
                last_step_info=recover.StepInfo(
                    epoch=self._cur_epoch,
                    epoch_step=self._cur_epoch_step,
                    global_step=self.global_step),
                hash_vals_to_ignore=list(self._consumed_ids),
                dataloader_state=dict(
                    epoch=self._cur_epoch,
                    epoch_step=self._cur_epoch_step)))

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
        """Run the configured epochs (or benchmark steps), then save every
        trained role once more; returns the last step's stats."""
        spec = self.spec
        last_stats = {}
        done = False
        self._consumed_ids = list(self._ids_to_skip)
        self._cur_epoch = self._start_epoch
        self._cur_epoch_step = self._start_epoch_step
        for epoch in range(self._start_epoch, spec.total_train_epochs):
            self._cur_epoch = epoch
            for step, batch in enumerate(self.dataloader):
                self._cur_epoch_step = step
                if self._ids_to_skip:
                    # the first epoch after a resume: drop the data the
                    # interrupted run consumed
                    batch = data_api.drop_ids(batch, self._ids_to_skip)
                    if batch is None:
                        continue
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
                self._consumed_ids.extend(batch.ids)
                self._maybe_save(steps=1)
                self._maybe_eval(steps=1)
                if (spec.ctl.benchmark_steps is not None
                        and self.global_step >= spec.ctl.benchmark_steps):
                    done = True
                    break
            if done:
                break
            self._ids_to_skip = set()
            self._consumed_ids = []
            self._maybe_save(epochs=1)
            self._maybe_eval(epochs=1)
        self._maybe_save(force=True)
        return last_stats
