"""PPO actor and critic interfaces.

The actor's three handlers (generate / inference / train_step) and the
critic's two (inference / train_step): KL-penalized rewards, GAE,
advantage and value normalization, clipped PPO losses, adaptive KL
control, logits-mask replay, early stopping, and the staleness handling
of asynchronously generated samples.
"""

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from realhf_tpu_torch.api import model as model_api
from realhf_tpu_torch.api.data import SequenceSample
from realhf_tpu_torch.base.datapack import flat2d
from realhf_tpu_torch.engine import packing
from realhf_tpu_torch.interfaces import common, ppo_functional
from realhf_tpu_torch.interfaces.gen import sampling_generator
from realhf_tpu_torch.models import transformer as T
from realhf_tpu_torch.ops import functional as F
from realhf_tpu_torch.ops.gae import gae_packed_numpy
from realhf_tpu_torch.ops.sampling import GenerationHyperparameters


def _shifted_loss_mask(prompt_mask: np.ndarray,
                       seqlens: List[int]) -> np.ndarray:
    """Flat l-1 mask per sequence: True where the *predicted* token is
    a non-prompt token."""
    out, off = [], 0
    for l in seqlens:
        pm = prompt_mask[off:off + l]
        out.append(~pm[1:])
        off += l
    return np.concatenate(out)


def _make_rms(norm_type: str, beta: float, eps: float):
    if norm_type == "exp":
        return ppo_functional.ExponentialRunningMeanStd(beta=beta,
                                                        epsilon=eps)
    if norm_type == "ma":
        return ppo_functional.MovingAverageRunningMeanStd(epsilon=eps)
    raise NotImplementedError(norm_type)


def _make_kl_adapter(adaptive: bool, kl_ctl: float, target: float,
                     horizon: float):
    if adaptive:
        return ppo_functional.AdaptiveKLController(kl_ctl, target, horizon)
    return ppo_functional.FixedKLController(kl_ctl)


def _has(input_: SequenceSample, key: str) -> bool:
    return key in input_.keys and input_.data.get(key) is not None


@dataclasses.dataclass
class _RolloutView:
    """What both train steps read from a rollout batch: the flat arrays,
    the de-normalized values with the value at the EOS of a terminated
    sequence zeroed, the shifted loss mask, and the KL-penalized
    rewards."""
    seqlens: List[int]
    cu: np.ndarray            # [n_seqs + 1] bounds of the length-l arrays
    short1: np.ndarray        # [n_seqs + 1] bounds of the length-(l-1) arrays
    old_logp: np.ndarray
    ref_logp: np.ndarray
    prompt_mask: np.ndarray
    reward_score: np.ndarray
    values: np.ndarray
    denorm_values: np.ndarray
    seq_no_eos: np.ndarray
    loss_mask: np.ndarray
    dense: Optional[np.ndarray] = None
    kl_rewards: Optional[np.ndarray] = None
    rewards: Optional[np.ndarray] = None

    @property
    def n_seqs(self) -> int:
        return len(self.seqlens)


def _rollout_view(itf, input_: SequenceSample) -> _RolloutView:
    seqlens = common.flat_seqlens(input_)
    n_seqs = len(seqlens)
    cu = np.concatenate([[0], np.cumsum(seqlens)]).astype(np.int64)
    values = np.asarray(input_.data["values"], np.float32).copy()
    seq_no_eos = np.asarray(input_.data["seq_no_eos_mask"], bool)
    denorm_values = (itf.rms.denormalize(values) if itf.value_norm
                     else values.copy())
    ends = cu[1:] - 1
    denorm_values[ends] = np.where(seq_no_eos, denorm_values[ends], 0.0)
    prompt_mask = np.asarray(input_.data["prompt_mask"], bool)
    dense = None
    if itf.turn_level_credit and _has(input_, "dense_rewards"):
        dense = np.asarray(input_.data["dense_rewards"], np.float32)
    return _RolloutView(
        seqlens=seqlens, cu=cu, short1=cu - np.arange(n_seqs + 1),
        old_logp=np.asarray(input_.data["packed_logprobs"], np.float32),
        ref_logp=np.asarray(input_.data["packed_ref_logprobs"], np.float32),
        prompt_mask=prompt_mask,
        reward_score=np.asarray(input_.data["rewards"], np.float32),
        values=values, denorm_values=denorm_values, seq_no_eos=seq_no_eos,
        loss_mask=_shifted_loss_mask(prompt_mask, seqlens), dense=dense)


def _fill_rewards(itf, v: _RolloutView):
    """Mask the log-probs, then the KL-penalized rewards: the score at
    the end of each sequence, or ``dense_rewards`` at the turn ends."""
    v.old_logp = v.old_logp * v.loss_mask
    v.ref_logp = v.ref_logp * v.loss_mask
    if v.dense is not None:
        v.kl_rewards, v.rewards = ppo_functional.get_packed_dense_rewards(
            kl_ctl=itf.kl_adapter.value,
            clip_reward_value=itf.max_reward_clip,
            log_probs=v.old_logp, ref_log_probs=v.ref_logp,
            dense_rewards=v.dense)
    else:
        v.kl_rewards, v.rewards = ppo_functional.get_packed_rewards(
            kl_ctl=itf.kl_adapter.value,
            clip_reward_value=itf.max_reward_clip,
            log_probs=v.old_logp, ref_log_probs=v.ref_logp,
            reward_score=v.reward_score, short1cu_seqlens=v.short1,
            seq_no_eos_mask=v.seq_no_eos)


def _mean_stats(all_stats: List[Dict]) -> Dict:
    return {k: float(np.mean([s[k] for s in all_stats]))
            for k in all_stats[0]}


@dataclasses.dataclass
class PPOActorInterface(model_api.ModelInterface):
    n_minibatches: int = 4
    gconfig: GenerationHyperparameters = dataclasses.field(
        default_factory=GenerationHyperparameters)
    kl_ctl: float = 0.1
    discount: float = 1.0
    gae_lambda: float = 1.0
    eps_clip: float = 0.2
    max_reward_clip: float = 20.0
    early_stop_kl: Optional[float] = None
    early_stop_imp_ratio: Optional[float] = None
    adv_norm: bool = True
    use_adaptive_kl_ctl: bool = False
    adaptive_kl_target: float = 6.0
    adaptive_kl_horizon: float = 10000.0
    value_norm: bool = False
    value_norm_type: str = "exp"
    value_norm_beta: float = 0.99995
    value_norm_eps: float = 1e-5
    #: False: ``save`` writes nothing
    enable_save: bool = True
    #: drop sequences whose generation weight version
    #: (``metadata["weight_version"]``) lags the trainer's current
    #: version by more than this; None keeps everything
    max_staleness: Optional[int] = None
    #: truncated importance-sampling bound for STALE sequences: each
    #: stale token's advantage is scaled by
    #: clip(pi_current / pi_behavior, 1/c, c), the ratio detached (the
    #: ordinary PPO ratio still does the proximal clipping on top). None
    #: disables the correction; fresh sequences are never touched.
    staleness_is_clip: Optional[float] = 2.0
    #: place reward at each turn's last action token (the
    #: ``dense_rewards`` key of multi-turn trajectories) instead of at
    #: the end of the sequence; GAE then carries credit across the masked
    #: observation gaps. Also off when the batch has no ``dense_rewards``.
    turn_level_credit: bool = False

    def __post_init__(self):
        if isinstance(self.gconfig, dict):
            self.gconfig = GenerationHyperparameters(**self.gconfig)
        self.kl_adapter = _make_kl_adapter(
            self.use_adaptive_kl_ctl, self.kl_ctl, self.adaptive_kl_target,
            self.adaptive_kl_horizon)
        if self.value_norm:
            self.rms = _make_rms(self.value_norm_type, self.value_norm_beta,
                                 self.value_norm_eps)
        self._gen_calls = 0

    # ------------------------------------------------------------------
    def generate(self, model: model_api.Model, input_: SequenceSample,
                 n_mbs: Optional[int] = None) -> SequenceSample:
        engine = model.engine
        tok = model.tokenizer
        prompt_lens = flat2d(input_.seqlens["packed_prompts"])
        flat = input_.data["packed_prompts"]
        prompts, off = [], 0
        for l in prompt_lens:
            prompts.append(np.asarray(flat[off:off + l]))
            off += l

        ids, seg, pos = packing.left_padded_prompts(
            prompts, pad_id=tok.pad_token_id)
        self._gen_calls += 1
        out = engine.generate(
            ids, seg, pos, sampling_generator(self._gen_calls, engine.device),
            self.gconfig, eos_token_id=tok.eos_token_id,
            pad_token_id=tok.pad_token_id).to_host()
        keep_mask = (out.logits_mask is not None
                     and not self.gconfig.force_no_logits_mask)

        seqlens, in_ids, logprobs, prompt_mask, logits_masks = [], [], [], [], []
        vocab = model.config.vocab_size
        for i, p in enumerate(prompts):
            g = int(out.lengths[i])
            l = len(p) + g
            seqlens.append(l)
            in_ids.append(np.concatenate([p, out.tokens[i, :g]]))
            lp = np.zeros(l - 1, np.float32)
            lp[len(p) - 1:] = out.logprobs[i, :g]
            logprobs.append(lp)
            prompt_mask.append(np.concatenate(
                [np.ones(len(p), bool), np.zeros(g, bool)]))
            if keep_mask:
                # stored True = masked out; the engine's is True = allowed
                m = np.zeros((l, vocab), bool)
                m[len(p) - 1:len(p) - 1 + g] = ~out.logits_mask[i, :g]
                logits_masks.append(m)

        data = dict(
            seq_no_eos_mask=np.asarray(out.no_eos_mask),
            packed_input_ids=np.concatenate(in_ids).astype(np.int32),
            packed_logprobs=np.concatenate(logprobs).astype(np.float32),
            prompt_mask=np.concatenate(prompt_mask),
        )
        if keep_mask:
            data["packed_logits_mask"] = np.concatenate(logits_masks)
        return SequenceSample.from_default(
            ids=input_.ids, seqlens=seqlens, data=data)

    # ------------------------------------------------------------------
    def inference(self, model: model_api.Model, input_: SequenceSample,
                  n_mbs: Optional[int] = None) -> SequenceSample:
        """Log-probs of the batch's tokens under this model (the
        ``ref_inf`` MFC), in ``n_mbs`` chunks so that a batch too large
        for the card at once still runs."""
        has_mask = _has(input_, "packed_logits_mask")
        pieces = []
        # split() is contiguous and keeps the order: the chunks' outputs
        # concatenate back into the input order
        for chunk in common.split_minibatches(input_, n_mbs or 1):
            seqlens = common.flat_seqlens(chunk)
            sb = common.build_stream_batch(
                seqlens,
                n_streams=model.engine.n_streams,
                token_keys=dict(input_ids=chunk.data["packed_input_ids"]))
            lmask = None
            if has_mask:
                # stored True = masked out; the engine wants True = allowed
                lmask = packing.pack_tokens(
                    sb.info, ~chunk.data["packed_logits_mask"], fill=True)
            lp = model.engine.forward_logprobs(
                sb.arrays["input_ids"], sb.arrays["seg_ids"],
                temperature=self.gconfig.temperature,
                logits_mask=lmask).cpu().numpy()
            pieces.append(packing.unpack_tokens(
                sb.info, lp, seqlens=[l - 1 for l in seqlens]))
        flat_lp = np.concatenate(pieces)
        # keep each element's nesting (an element may hold a group of
        # sequences)
        nested_m1 = [[l - 1 for l in lens]
                     for lens in input_.seqlens["packed_input_ids"]]
        with SequenceSample.disable_validation():
            return SequenceSample(
                keys=["packed_ref_logprobs"],
                trailing_shapes=dict(packed_ref_logprobs=()),
                dtypes=dict(packed_ref_logprobs=np.float32),
                ids=list(input_.ids),
                seqlens=dict(packed_ref_logprobs=nested_m1),
                data=dict(packed_ref_logprobs=flat_lp.astype(np.float32)),
                metadata={})

    # ------------------------------------------------------------------
    def train_step(self, model: model_api.Model, input_: SequenceSample,
                   n_mbs: Optional[int] = None) -> Dict:
        v = _rollout_view(self, input_)
        seqlens, n_seqs, loss_mask = v.seqlens, v.n_seqs, v.loss_mask

        # staleness: asynchronous rollouts stamp each sample with the
        # weight version that generated it; staleness is the trainer's
        # version minus that stamp. Over-stale sequences drop out of the
        # loss; the rest get the clipped-IS correction inside the loss.
        versions = input_.metadata.get("weight_version")
        cur_version = model.version.global_step
        seq_staleness = np.zeros(n_seqs, np.int64)
        if versions:
            seq_staleness = np.array(
                [max(0, cur_version - int(x)) for x in versions], np.int64)
        n_dropped = 0
        if versions and self.max_staleness is not None:
            drop = seq_staleness > self.max_staleness
            for i in np.flatnonzero(drop):
                loss_mask[v.short1[i]:v.short1[i + 1]] = False
            n_dropped = int(drop.sum())

        _fill_rewards(self, v)
        advantages, returns = gae_packed_numpy(
            v.rewards, v.denorm_values, v.short1,
            v.seq_no_eos.astype(np.float32),
            gamma=self.discount, lam=self.gae_lambda)

        if self.value_norm:
            self.rms.update(returns, mask=loss_mask)
        if self.adv_norm:
            m = loss_mask.astype(np.float64)
            denom = max(m.sum(), 1.0)  # every sequence dropped as stale
            mean = (advantages * m).sum() / denom
            var = ((advantages - mean) ** 2 * m).sum() / denom
            advantages = ((advantages - mean) /
                          np.sqrt(var + 1e-5)).astype(np.float32) * loss_mask

        n_tokens = int(loss_mask.sum())
        mean_ref_kl = float((v.kl_rewards * loss_mask).sum())
        self.kl_adapter.update(mean_ref_kl / max(n_tokens, 1),
                               n_steps=n_seqs)

        global_stats = dict(
            task_reward=float(v.reward_score.mean()),
            kl_reward=mean_ref_kl / max(n_tokens, 1),
            advantage=float(advantages.sum() / max(n_tokens, 1)),
            avg_seq_len=float(np.mean(seqlens)),
            avg_prompt_len=float(v.prompt_mask.sum() / n_seqs),
            n_tokens=n_tokens,
            n_seqs=n_seqs,
        )
        if versions:
            global_stats.update(
                staleness_mean=float(seq_staleness.mean()),
                staleness_max=int(seq_staleness.max()),
                stale_seq_frac=float((seq_staleness > 0).mean()),
                n_dropped_stale=n_dropped)
        if v.dense is not None:
            global_stats["dense_reward_sum"] = float(v.dense.sum())
        if input_.metadata.get("n_turns"):
            global_stats["avg_turns"] = float(
                np.mean(input_.metadata["n_turns"]))

        train_data = dict(
            advantages=advantages,
            old_logp=v.old_logp,
            ppo_loss_mask=loss_mask,
            packed_input_ids=input_.data["packed_input_ids"],
            kl_rewards=v.kl_rewards,
        )
        # per-token staleness (shifted, length l-1) rides the minibatch
        # so that the clipped-IS correction runs inside the loss
        has_stale = bool(versions) and self.staleness_is_clip is not None
        if has_stale:
            train_data["staleness"] = np.repeat(
                seq_staleness, [l - 1 for l in seqlens]).astype(np.float32)
        has_mask = _has(input_, "packed_logits_mask")
        if has_mask:
            train_data["packed_logits_mask"] = \
                input_.data["packed_logits_mask"]
        sample = SequenceSample.from_default(
            ids=input_.ids,
            seqlens=[[l] for l in common.seqlens_of(input_)],
            data=train_data)

        cfg = model.config
        temperature = self.gconfig.temperature
        eps_clip = self.eps_clip
        early_kl = self.early_stop_kl
        early_imp = self.early_stop_imp_ratio
        is_clip = self.staleness_is_clip

        def loss_fn(params, mb):
            h, aux = common.forward_with_aux(cfg, params, mb["input_ids"],
                                             mb["seg_ids"])
            lp = F.shifted_logprobs_from_hidden(
                cfg, params, h, mb["input_ids"], mb["seg_ids"],
                temperature=temperature, logits_mask=mb.get("logits_mask"))
            adv = mb["advantages"]
            lm = mb["loss_mask"] > 0
            stale_stats = {}
            if has_stale:
                behav_ratio = torch.exp(lp.detach() - mb["old_logp"])
                w = torch.where(
                    mb["staleness"] > 0,
                    behav_ratio.clamp(1.0 / is_clip, is_clip), 1.0)
                adv = adv * w
                stale_stats["stale_is_weight"] = (
                    (w * lm).sum() / lm.sum().clamp_min(1))
            loss, stats = ppo_functional.actor_loss_fn(
                logprobs=lp, old_logprobs=mb["old_logp"],
                advantages=adv, eps_clip=eps_clip, loss_mask=lm)
            out_stats = dict(
                actor_loss=loss.detach(),
                ppo_approx_kl=stats["approx_kl"],
                actor_clip_ratio=stats["clip_ratio"],
                importance_weight=stats["importance_weight"],
                **stale_stats, **aux)
            # early stop SKIPS the whole optimizer update through the
            # engine's reserved stat: a zeroed loss would still apply
            # AdamW's weight decay
            if early_imp is not None or early_kl is not None:
                skip = torch.zeros_like(loss.detach())
                if early_imp is not None:
                    skip = torch.maximum(
                        skip, (stats["importance_weight"] > early_imp)
                        .float())
                if early_kl is not None:
                    skip = torch.maximum(
                        skip, (stats["approx_kl"] > early_kl).float())
                out_stats["__skip_update__"] = skip
            return loss + sum(aux.values()), out_stats

        def build_sb(minibatch):
            shifted = dict(
                advantages=minibatch.data["advantages"],
                old_logp=minibatch.data["old_logp"],
                loss_mask=minibatch.data["ppo_loss_mask"]
                .astype(np.float32))
            if has_stale:
                shifted["staleness"] = minibatch.data["staleness"]
            sb = common.build_stream_batch(
                common.flat_seqlens(minibatch),
                n_streams=model.engine.n_streams,
                token_keys=dict(
                    input_ids=minibatch.data["packed_input_ids"]),
                shifted_keys=shifted)
            if has_mask:
                sb.arrays["logits_mask"] = packing.pack_tokens(
                    sb.info, ~minibatch.data["packed_logits_mask"],
                    fill=True)
            return sb

        # one optimizer step per minibatch; ``n_mbs`` splits each
        # minibatch again, for memory, into microbatches whose gradients
        # accumulate into that one step
        all_stats = common.run_train_minibatches(
            model.engine,
            common.split_minibatches(sample, self.n_minibatches),
            build_sb, loss_fn, "ppo_actor", n_mbs)
        model.inc_version()

        agg = _mean_stats(all_stats)
        agg.update(global_stats)
        return agg

    def save(self, model: model_api.Model, save_dir: str, host_params=None):
        if not self.enable_save:
            return
        common.save_checkpoint(model, save_dir, host_params)


@dataclasses.dataclass
class PPOCriticInterface(model_api.ModelInterface):
    n_minibatches: int = 4
    kl_ctl: float = 0.1
    discount: float = 1.0
    gae_lambda: float = 0.95
    value_eps_clip: float = 0.2
    max_reward_clip: float = 20.0
    adaptive_kl_target: float = 6.0
    adaptive_kl_horizon: float = 10000.0
    use_adaptive_kl_ctl: bool = False
    value_norm: bool = False
    value_norm_type: str = "exp"
    value_norm_beta: float = 0.99995
    value_norm_eps: float = 1e-5
    #: False: ``save`` writes nothing
    enable_save: bool = True
    #: must equal the actor's: the critic's regression target comes from
    #: the same reward placement
    turn_level_credit: bool = False

    def __post_init__(self):
        self.kl_adapter = _make_kl_adapter(
            self.use_adaptive_kl_ctl, self.kl_ctl, self.adaptive_kl_target,
            self.adaptive_kl_horizon)
        if self.value_norm:
            self.rms = _make_rms(self.value_norm_type, self.value_norm_beta,
                                 self.value_norm_eps)

    def inference(self, model: model_api.Model, input_: SequenceSample,
                  n_mbs: Optional[int] = None) -> SequenceSample:
        """A value for every token, in ``n_mbs`` chunks."""
        pieces = []
        for chunk in common.split_minibatches(input_, n_mbs or 1):
            sb = common.build_stream_batch(
                common.flat_seqlens(chunk),
                n_streams=model.engine.n_streams,
                token_keys=dict(input_ids=chunk.data["packed_input_ids"]))
            values = model.engine.forward_values(
                sb.arrays["input_ids"], sb.arrays["seg_ids"]).cpu().numpy()
            pieces.append(packing.unpack_tokens(sb.info, values))
        return SequenceSample.from_default(
            ids=input_.ids, seqlens=common.flat_seqlens(input_),
            data=dict(values=np.concatenate(pieces).astype(np.float32)))

    def train_step(self, model: model_api.Model, input_: SequenceSample,
                   n_mbs: Optional[int] = None) -> Dict:
        v = _rollout_view(self, input_)
        ends = v.cu[1:] - 1
        v.values[ends] = np.where(v.seq_no_eos, v.values[ends], 0.0)
        _fill_rewards(self, v)
        # keep the critic's adaptive KL coefficient in step with the
        # actor's
        n_tokens = max(int(v.loss_mask.sum()), 1)
        self.kl_adapter.update(
            float((v.kl_rewards * v.loss_mask).sum()) / n_tokens,
            n_steps=v.n_seqs)
        _, returns = gae_packed_numpy(
            v.rewards, v.denorm_values, v.short1,
            v.seq_no_eos.astype(np.float32),
            gamma=self.discount, lam=self.gae_lambda)

        if self.value_norm:
            self.rms.update(returns, mask=v.loss_mask)
            target = self.rms.normalize(returns)
        else:
            target = returns

        # the old value at every predicting position: values[t] for t in
        # 0..l-2 (flat l-1)
        old_values_short = np.concatenate(
            [v.values[v.cu[i]:v.cu[i + 1] - 1] for i in range(v.n_seqs)])

        sample = SequenceSample.from_default(
            ids=input_.ids,
            seqlens=[[l] for l in common.seqlens_of(input_)],
            data=dict(
                packed_input_ids=input_.data["packed_input_ids"],
                returns=target.astype(np.float32),
                # ``from_default`` gives a "values" key length l; these
                # are l-1, so they travel under an l-1 key's name
                old_logp=old_values_short.astype(np.float32),
                ppo_loss_mask=v.loss_mask,
            ))

        cfg = model.config
        eps = self.value_eps_clip

        def loss_fn(params, mb):
            h, aux = common.forward_with_aux(cfg, params, mb["input_ids"],
                                             mb["seg_ids"])
            new_values = T.critic_values(cfg, params, h)
            loss, stats = ppo_functional.critic_loss_fn(
                value=new_values, old_value=mb["old_values"],
                target_value=mb["returns"], value_eps_clip=eps,
                loss_mask=mb["loss_mask"] > 0)
            return loss + sum(aux.values()), dict(
                value_loss=loss.detach(),
                value_clip_ratio=stats["value_clip_ratio"], **aux)

        def build_sb(minibatch):
            return common.build_stream_batch(
                common.flat_seqlens(minibatch),
                n_streams=model.engine.n_streams,
                token_keys=dict(
                    input_ids=minibatch.data["packed_input_ids"]),
                shifted_keys=dict(
                    returns=minibatch.data["returns"],
                    old_values=minibatch.data["old_logp"],
                    loss_mask=minibatch.data["ppo_loss_mask"]
                    .astype(np.float32)))

        all_stats = common.run_train_minibatches(
            model.engine,
            common.split_minibatches(sample, self.n_minibatches),
            build_sb, loss_fn, "ppo_critic", n_mbs)
        model.inc_version()

        agg = _mean_stats(all_stats)
        agg["returns"] = float(returns.mean())
        return agg

    def save(self, model: model_api.Model, save_dir: str, host_params=None):
        if not self.enable_save:
            return
        common.save_checkpoint(model, save_dir, host_params)


model_api.register_interface("ppo_actor", PPOActorInterface)
model_api.register_interface("ppo_critic", PPOCriticInterface)
