"""The SFT slice end to end: the ``sft`` experiment built by each
package's ``SFTConfig`` and run by each package's ``InlineRunner`` on a
tiny random model (the JAX weights carried into the port), two epochs
of two steps of two microbatches, evaluated on the same file after each
epoch. Every step's loss and grad norm and every evaluation must agree.

Tolerances: fp32 on the CPU on both sides; the sums differ in order, and
four AdamW steps let those differences grow to ~1e-6 relative in the
losses: 1e-4 relative.
"""

import json

import numpy as np
import pytest

from realhf_tpu.base.testing import IntegerTokenizer as JaxTokenizer
from realhf_tpu.experiments.common import apply_overrides as jax_overrides
from realhf_tpu.experiments.sft_exp import SFTConfig as JaxSFTConfig
from realhf_tpu.system.inline import InlineRunner as JaxRunner
from realhf_tpu_torch.base.testing import IntegerTokenizer
from realhf_tpu_torch.experiments.common import apply_overrides
from realhf_tpu_torch.experiments.sft_exp import SFTConfig
from realhf_tpu_torch.system.inline import InlineRunner

TINY = dict(n_layers=2, n_kv_heads=2, n_q_heads=4, hidden_dim=32,
            intermediate_dim=64, vocab_size=1100, apply_rotary=True,
            layer_norm_type="rms", mlp_type="llama",
            use_attention_bias=False, use_attn_proj_bias=False,
            use_mlp_bias=False, activation_function="silu")
OVERRIDES = {"dataset.train_bs_n_seqs": "8", "dataset.max_seqlen": "32",
             "n_mbs": "2", "total_train_epochs": "2",
             "eval_freq_epochs": "1", "model.bf16": "false",
             "model.optimizer.lr": "1e-2",
             "model.optimizer.lr_scheduler_type": "constant",
             "model.optimizer.warmup_steps_proportion": "0"}


def _data(path):
    rng = np.random.default_rng(4)
    with open(path, "w") as f:
        for i in range(16):
            words = rng.integers(0, 50, size=int(rng.integers(3, 12)))
            answer = rng.integers(0, 20, size=int(rng.integers(2, 9)))
            f.write(json.dumps({
                "id": i, "prompt": " ".join(f"w{int(w)}" for w in words),
                "answer": " " + " ".join(f"a{int(a)}" for a in answer)})
                + "\n")


def _spec(cfg_cls, overrides, tok, path):
    cfg = cfg_cls(experiment_name="sft-e2e", trial_name="t0")
    overrides(cfg, dict(OVERRIDES, **{"dataset.path": path,
                                      "dataset.valid_path": path}))
    spec = cfg.build()
    spec.models["default"].random_init_config = dict(TINY)
    spec.tokenizer = tok
    return spec


def test_sft_experiment_matches_jax(tmp_path):
    path = str(tmp_path / "sft.jsonl")
    _data(path)
    jr = JaxRunner(_spec(JaxSFTConfig, jax_overrides,
                         JaxTokenizer(vocab_size=1000), path))
    runner = InlineRunner(_spec(SFTConfig, apply_overrides,
                                IntegerTokenizer(vocab_size=1000), path),
                          device="cpu")
    runner.models["default"].engine.set_params(
        jr.models["default"].engine.params_numpy())

    # the JAX runner step by step (its run() also saves a checkpoint)
    want_steps, want_evals = [], []
    itf = jr.interfaces["trainDefault"]
    for _ in range(2):
        for batch in jr.dataloader:
            want_steps.append(jr.run_step(batch)["trainDefault"])
        want_evals.append(itf.evaluate(jr.models["default"],
                                       jr.eval_dataloader))
    runner.run()
    got_steps = [s["trainDefault"] for s in runner.step_stats]
    assert len(got_steps) == len(want_steps) == 4
    for got, want in zip(got_steps, want_steps):
        for k in ("loss", "grad_norm", "nll", "n_tokens"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)
    assert [(step, name) for step, name, _ in runner.eval_stats] == \
        [(2, "trainDefault"), (4, "trainDefault")]
    for (_, _, got), want in zip(runner.eval_stats, want_evals):
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-4)
        np.testing.assert_allclose(got["ppl"], want["ppl"], rtol=1e-4)
    assert got_steps[-1]["loss"] < got_steps[0]["loss"]


def test_quickstart_cli_runs_sft_on_cpu(tmp_path):
    from realhf_tpu_torch.apps.quickstart import main
    path = str(tmp_path / "sft.jsonl")
    _data(path)
    args = ["sft", "model.random_init_size=tiny", f"dataset.path={path}",
            "dataset.train_bs_n_seqs=8", "n_mbs=2", "device=cpu"]
    stats = main(args)
    assert np.isfinite(stats["trainDefault"]["loss"])
    with pytest.raises(NotImplementedError, match="checkpoint-IO"):
        main(args + ["save_freq_epochs=1"])
