"""The generation slice end to end: the ``gen`` experiment built by each
package's ``GenerationConfig`` and run by each package's
``InlineRunner`` on a tiny random model, the JAX weights carried into
the port with ``params_from_numpy``. Greedy decoding must produce the
same ``packed_input_ids`` for every prompt (fp32 on the CPU: the two
sides differ only in summation order, far below the logit gaps that
decide a greedy token on this model)."""

import json

import numpy as np

from realhf_tpu.base.testing import IntegerTokenizer as JaxTokenizer
from realhf_tpu.experiments.common import apply_overrides as jax_overrides
from realhf_tpu.experiments.gen_exp import GenerationConfig as JaxGenConfig
from realhf_tpu.system.inline import InlineRunner as JaxRunner
from realhf_tpu_torch.base.testing import IntegerTokenizer
from realhf_tpu_torch.experiments.common import apply_overrides
from realhf_tpu_torch.experiments.gen_exp import GenerationConfig
from realhf_tpu_torch.models.convert import params_from_numpy
from realhf_tpu_torch.system.inline import InlineRunner

TINY = dict(n_layers=2, n_kv_heads=2, n_q_heads=4, hidden_dim=32,
            intermediate_dim=64, vocab_size=1100, apply_rotary=True,
            layer_norm_type="rms", mlp_type="llama",
            use_attention_bias=False, use_attn_proj_bias=False,
            use_mlp_bias=False, activation_function="silu")
OVERRIDES = {"dataset.train_bs_n_seqs": "4", "dataset.max_seqlen": "16",
             "max_new_tokens": "6", "greedy": "true",
             "benchmark_steps": "2"}


def _prompts(path):
    rng = np.random.default_rng(1)
    with open(path, "w") as f:
        for i in range(8):
            words = rng.integers(0, 50, size=int(rng.integers(2, 9)))
            f.write(json.dumps({"id": i, "prompt": " ".join(
                f"w{int(w)}" for w in words)}) + "\n")


def _spec(cfg_cls, overrides, tok, path):
    cfg = cfg_cls(experiment_name="gen-e2e", trial_name="t0")
    overrides(cfg, dict(OVERRIDES, **{"dataset.path": path}))
    spec = cfg.build()
    mspec = spec.models["default"]
    mspec.path = None
    mspec.random_init_config = dict(TINY)
    mspec.bf16 = False
    spec.tokenizer = tok
    return spec


def _generated(runner):
    out = {}
    for batch in runner.dataloader:
        runner.run_step(batch)
        flat, off = batch.data["packed_input_ids"], 0
        for i, lens in zip(batch.ids, batch.seqlens["packed_input_ids"]):
            out[i] = flat[off:off + lens[0]].tolist()
            off += lens[0]
    return out


def test_gen_experiment_matches_jax(tmp_path):
    path = str(tmp_path / "prompts.jsonl")
    _prompts(path)
    jax_runner = JaxRunner(_spec(JaxGenConfig, jax_overrides,
                                 JaxTokenizer(vocab_size=1000), path))
    runner = InlineRunner(_spec(GenerationConfig, apply_overrides,
                                IntegerTokenizer(vocab_size=1000), path),
                          device="cpu")
    weights = jax_runner.models["default"].engine.params_numpy()
    runner.models["default"].engine.set_params(params_from_numpy(weights))

    want = _generated(jax_runner)
    got = _generated(runner)
    assert sorted(got) == sorted(want) == list(range(8))
    for i in want:
        assert got[i] == want[i], (i, got[i], want[i])
        assert len(got[i]) > 0


def test_runner_run_honours_benchmark_steps(tmp_path):
    path = str(tmp_path / "prompts.jsonl")
    _prompts(path)
    runner = InlineRunner(_spec(GenerationConfig, apply_overrides,
                                IntegerTokenizer(vocab_size=1000), path),
                          device="cpu")
    runner.run()
    assert runner.global_step == 2 and len(runner.step_secs) == 2
    eng = runner.models["default"].engine
    assert len(eng.generate_stats) == 2
    assert all(1 <= s["decode_steps"] <= 6 for s in eng.generate_stats)
    ids = runner.last_batch.data["packed_input_ids"]
    assert ids.dtype == np.int32 and 0 <= ids.min() and ids.max() < 1100


def test_quickstart_cli_runs_gen_on_cpu(tmp_path):
    from realhf_tpu_torch.apps.quickstart import main
    path = str(tmp_path / "prompts.jsonl")
    _prompts(path)
    out = tmp_path / "gen.jsonl"
    main(["gen", "model.random_init_size=tiny", f"dataset.path={path}",
          "dataset.train_bs_n_seqs=4", "max_new_tokens=3", "greedy=true",
          "device=cpu", f"output_file={out}", "benchmark_steps=1"])
    records = [json.loads(line) for line in out.read_text().splitlines()]
    assert len(records) == 4
    assert all(r["answer"] for r in records)


def test_deferred_features_raise(tmp_path):
    import pytest

    from realhf_tpu_torch.apps.quickstart import main
    path = str(tmp_path / "prompts.jsonl")
    _prompts(path)
    with pytest.raises(NotImplementedError):  # checkpoint IO
        main(["gen", "model.path=/nonexistent", f"dataset.path={path}",
              "device=cpu"])
    with pytest.raises(NotImplementedError):  # more than one device
        main(["gen", "model.random_init_size=tiny", f"dataset.path={path}",
              "model.parallel.tensor_parallel_size=2", "device=cpu"])
