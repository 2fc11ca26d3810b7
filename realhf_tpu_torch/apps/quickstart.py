"""Quickstart CLI: ``python -m realhf_tpu_torch.apps.quickstart <exp> a.b=c ...``

One subcommand per registered experiment, configured by dotted
key=value overrides, run by the inline runner on the CUDA card
(``device=cpu`` for the plain PyTorch path), e.g.::

    python -m realhf_tpu_torch.apps.quickstart gen \\
        model.random_init_size=7b dataset.path=prompts.jsonl \\
        dataset.train_bs_n_seqs=8 max_new_tokens=128 greedy=true
    python -m realhf_tpu_torch.apps.quickstart sft \\
        model.random_init_size=tiny dataset.path=prompt_answer.jsonl \\
        dataset.train_bs_n_seqs=8 n_mbs=2 device=cpu

Random-weight models without a tokenizer path use the integer test
tokenizer (``base/testing.py``).
"""

import argparse
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
    vocabs = [m.random_init_config["vocab_size"]
              for m in spec.models.values() if m.random_init_config]
    if spec.tokenizer is None and spec.tokenizer_path is None and vocabs:
        from realhf_tpu_torch.base.testing import IntegerTokenizer
        spec.tokenizer = IntegerTokenizer(vocab_size=min(vocabs) - 2)

    from realhf_tpu_torch.system.inline import InlineRunner
    stats = InlineRunner(spec, device=cfg.device).run()
    logger.info("Experiment complete. Last step stats: %s", stats)
    return stats


if __name__ == "__main__":
    main()
