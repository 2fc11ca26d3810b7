"""Quickstart CLI: ``python -m realhf_tpu_torch.apps.quickstart <exp> a.b=c ...``

One subcommand per registered experiment, configured by dotted
key=value overrides, run by the inline runner on the CUDA card
(``device=cpu`` for the plain PyTorch path), e.g.::

    python -m realhf_tpu_torch.apps.quickstart gen \\
        model.random_init_size=7b dataset.path=prompts.jsonl \\
        dataset.train_bs_n_seqs=8 max_new_tokens=128 greedy=true
    python -m realhf_tpu_torch.apps.quickstart sft \\
        model.random_init_size=tiny dataset.path=prompt_answer.jsonl \\
        dataset.train_bs_n_seqs=8 n_mbs=2 device=cpu \\
        save_freq_steps=1 recover_mode=auto

``allocation_mode=heuristic n_devices=N`` plans each MFC's layout from
the models' sizes (``experiments/heuristic.py``; ``n_devices`` defaults
to the cards present, a ``device=cpu`` run gives it).

A run saves its trained roles under ``$REALHF_TPU_ROOT/checkpoints``;
the same command with ``recover_mode=resume`` continues it from the last
save. ``<role>.path=<dir>`` loads an HF-layout checkpoint. Models without
a tokenizer path use the integer test tokenizer (``base/testing.py``),
sized by the smallest vocabulary of the models.
"""

import argparse
import json
import os
import sys

from realhf_tpu_torch.base import logging

logger = logging.getLogger("quickstart")


def parse_overrides(tokens):
    out = {}
    for t in tokens:
        if "=" not in t:
            raise ValueError(f"Override `{t}` is not of the form key=value.")
        k, v = t.split("=", 1)
        out[k] = v
    return out


def _vocab_size(mspec) -> int:
    """The vocabulary of a model spec: its checkpoint's config.json, else
    its random-init config."""
    if mspec.path:
        with open(os.path.join(mspec.path, "config.json")) as f:
            return json.load(f)["vocab_size"]
    return mspec.random_init_config["vocab_size"]


def main(argv=None):
    import realhf_tpu_torch.experiments as experiments
    from realhf_tpu_torch.experiments.common import apply_overrides

    argv = argv if argv is not None else sys.argv[1:]
    parser = argparse.ArgumentParser("realhf_tpu_torch quickstart")
    parser.add_argument(
        "experiment", choices=sorted(experiments.ALL_EXPERIMENT_CLASSES))
    parser.add_argument("overrides", nargs="*",
                        help="dotted key=value config overrides")
    args = parser.parse_args(argv)

    cfg = experiments.ALL_EXPERIMENT_CLASSES[args.experiment]()
    apply_overrides(cfg, parse_overrides(args.overrides))
    logger.info("Running experiment %s: %s", args.experiment, cfg)
    spec = cfg.build()
    if spec.serving is not None:
        raise NotImplementedError(
            "Launching the serving experiment as a service needs the "
            "rollout server's transport between processes, which comes "
            "with the distributed runtime (ROADMAP.md, queue 1, item 5); "
            "drive serving/scheduler.py ContinuousScheduler in process "
            "until then.")
    if cfg.allocation_mode == "heuristic":
        from realhf_tpu_torch.experiments.heuristic import (
            apply_heuristic_allocations,
        )
        apply_heuristic_allocations(spec, cfg.heuristic_devices())
    vocabs = [_vocab_size(m) for m in spec.models.values()
              if m.random_init_config or m.path]
    # an experiment names its model's checkpoint as the tokenizer path
    # when none is given; the integer tokenizer stands in for that one
    if spec.tokenizer is None and cfg.tokenizer_path is None and vocabs:
        from realhf_tpu_torch.base.testing import IntegerTokenizer
        spec.tokenizer = IntegerTokenizer(vocab_size=min(vocabs) - 2)

    from realhf_tpu_torch.system.inline import InlineRunner
    stats = InlineRunner(spec, device=cfg.device,
                         recover_mode=cfg.recover_mode).run()
    logger.info("Experiment complete. Last step stats: %s", stats)
    return stats


if __name__ == "__main__":
    main()
