"""Save and resume through the runner, against the JAX package's.

- Recover info: a dump the JAX package wrote loads in the port in a
  process where neither ``jax`` nor ``realhf_tpu`` can be imported; a
  missing, truncated, corrupt, future-schema or foreign file gives None.
- A tiny ``sft`` run (3 steps of one epoch) interrupted after step 2
  (``save_freq_steps=1``, ``recover_mode="auto"``) and resumed by a new
  runner (``recover_mode="resume"``) takes the batch and reproduces the
  loss and grad norm of the uninterrupted run's step 3: the same ops on
  the same bits on the CPU, 1e-6 relative. The port's resumed run
  matches the JAX runner's own interrupted-and-resumed run, and the port
  resumes from the JAX run's checkpoint, optimizer state and recover
  info: fp32 on the CPU, sums in different orders, 1e-4 relative as in
  ``test_torch_sft_e2e.py``.
- The final save happens as in JAX (the same files), and the quickstart
  takes ``recover_mode=resume`` and ``<role>.path=``.
"""

import json
import os
import pathlib
import pickle
import shutil
import subprocess
import sys

import numpy as np
import pytest

import realhf_tpu.base.constants as jconstants
from realhf_tpu.base import recover as jrecover
from realhf_tpu.base.testing import IntegerTokenizer as JaxTokenizer
from realhf_tpu.experiments.common import apply_overrides as jax_overrides
from realhf_tpu.experiments.sft_exp import SFTConfig as JaxSFTConfig
from realhf_tpu.system.inline import InlineRunner as JaxRunner
from realhf_tpu_torch.base import constants, recover
from realhf_tpu_torch.base.testing import IntegerTokenizer
from realhf_tpu_torch.experiments.common import apply_overrides
from realhf_tpu_torch.experiments.sft_exp import SFTConfig
from realhf_tpu_torch.system.inline import InlineRunner
from test_torch_sft_e2e import TINY

REPO = pathlib.Path(__file__).resolve().parent.parent
OVERRIDES = {"dataset.train_bs_n_seqs": "8", "dataset.max_seqlen": "32",
             "n_mbs": "2", "total_train_epochs": "1", "model.bf16": "false",
             "model.optimizer.lr": "1e-2",
             "model.optimizer.lr_scheduler_type": "cosine",
             "model.optimizer.warmup_steps_proportion": "0"}
RESUME_TOL = dict(rtol=1e-6)
JAX_TOL = dict(rtol=1e-4)


@pytest.fixture(autouse=True)
def _port_root(tmp_path, monkeypatch):
    monkeypatch.setattr(constants, "ROOT_DIR", str(tmp_path / "port_root"))


@pytest.fixture
def data(tmp_path):
    path = str(tmp_path / "sft.jsonl")
    rng = np.random.default_rng(4)
    with open(path, "w") as f:
        for i in range(24):
            words = rng.integers(0, 50, size=int(rng.integers(3, 12)))
            answer = rng.integers(0, 20, size=int(rng.integers(2, 9)))
            f.write(json.dumps({
                "id": i, "prompt": " ".join(f"w{int(w)}" for w in words),
                "answer": " " + " ".join(f"a{int(a)}" for a in answer)})
                + "\n")
    return path


def _spec(jax, path, trial, **over):
    cls, apply, tok = ((JaxSFTConfig, jax_overrides, JaxTokenizer) if jax
                       else (SFTConfig, apply_overrides, IntegerTokenizer))
    cfg = cls(experiment_name="resume", trial_name=trial)
    apply(cfg, dict(OVERRIDES, **{"dataset.path": path},
                    **{k: str(v) for k, v in over.items()}))
    spec = cfg.build()
    spec.models["default"].random_init_config = dict(TINY)
    spec.tokenizer = tok(vocab_size=1000)
    return spec


def _run(jax, path, trial, weights=None, recover_mode="disabled", **over):
    """One runner's ``run``: (runner, [(batch ids, stats)] per step)."""
    spec = _spec(jax, path, trial, **over)
    runner = (JaxRunner(spec, recover_mode=recover_mode) if jax else
              InlineRunner(spec, device="cpu", recover_mode=recover_mode))
    if weights is not None:
        runner.models["default"].engine.set_params(weights)
    seen, step = [], runner.run_step

    def watched(batch):
        out = step(batch)
        seen.append((list(batch.ids), out["trainDefault"]))
        return out

    runner.run_step = watched
    runner.run()
    return runner, seen


def _interrupted_then_resumed(jax, path, trial, weights=None, between=None):
    """Steps 1-2 saving each step, then a new runner resuming step 3."""
    _, first = _run(jax, path, trial, weights, "auto", benchmark_steps=2,
                    save_freq_steps=1)
    if between is not None:
        between()
    runner, last = _run(jax, path, trial, None, "resume", benchmark_steps=3)
    return runner, first + last


def _assert_steps(got, want, tol):
    assert [ids for ids, _ in got] == [ids for ids, _ in want]
    for (_, g), (_, w) in zip(got, want):
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(g[k], w[k], err_msg=k, **tol)


def test_resume_reproduces_the_uninterrupted_run(data):
    _, full = _run(False, data, "full")
    runner, resumed = _interrupted_then_resumed(False, data, "cut")
    assert len(full) == len(resumed) == 3
    _assert_steps(resumed, full, RESUME_TOL)
    assert runner.global_step == 3
    info = recover.load("resume", "cut")
    assert info.last_step_info.global_step == 3
    assert sorted(info.hash_vals_to_ignore) == sorted(
        i for ids, _ in full for i in ids)


def test_resume_matches_jax_and_resumes_from_jax_files(data, tmp_path,
                                                      monkeypatch):
    """The JAX runner interrupted and resumed, the port likewise from the
    same initial weights, and the port resumed from the JAX run's files
    (a copy of its root taken between its two runners)."""
    w0 = JaxRunner(_spec(True, data, "w0")).models[
        "default"].engine.params_numpy()
    copy = tmp_path / "jax_root_after_step2"
    _, jax_steps = _interrupted_then_resumed(
        True, data, "cut", w0,
        between=lambda: shutil.copytree(jconstants.ROOT_DIR, copy))
    _, port_steps = _interrupted_then_resumed(False, data, "cut", w0)
    _assert_steps(port_steps, jax_steps, JAX_TOL)
    monkeypatch.setattr(constants, "ROOT_DIR", str(copy))
    _, from_jax = _run(False, data, "cut", None, "resume", benchmark_steps=3)
    _assert_steps(from_jax, jax_steps[2:], JAX_TOL)


def test_final_save_writes_what_jax_writes(data):
    _run(True, data, "final", benchmark_steps=1)
    _run(False, data, "final", benchmark_steps=1)
    jdir = os.path.join(jconstants.run_save_path("resume", "final"),
                        "default")
    pdir = os.path.join(constants.run_save_path("resume", "final"),
                        "default")
    assert sorted(os.listdir(pdir)) == sorted(os.listdir(jdir))
    assert "optimizer_state.npz" in os.listdir(pdir)
    # recover info only where the recover mode asks for it
    assert not recover.exists("resume", "final")
    assert not jrecover.exists("resume", "final")


def test_enable_save_false_keeps_the_sft_role_unsaved(data, tmp_path):
    """The port's sft interface takes ``enable_save`` (the JAX one takes
    no argument), as rw, dpo and the PPO interfaces do: off, the runner's
    saves, final one included, write nothing for the role."""
    spec = _spec(False, data, "nosave", benchmark_steps=1,
                 save_freq_steps=1)
    for node in spec.mfcs:
        node.interface_impl.args["enable_save"] = False
    runner = InlineRunner(spec, device="cpu")
    runner.run()
    assert os.listdir(constants.run_save_path("resume", "nosave")) == []
    direct = tmp_path / "direct"
    runner.interfaces["trainDefault"].save(runner.models["default"],
                                           str(direct))
    assert not direct.exists()


_CHILD = r"""
import importlib.abc, json, sys
class Blocker(importlib.abc.MetaPathFinder):
    def find_spec(self, fullname, path=None, target=None):
        if fullname.split(".")[0] in ("jax", "jaxlib", "realhf_tpu"):
            raise ImportError("blocked " + fullname)
        return None
sys.meta_path.insert(0, Blocker())
sys.path.insert(0, {repo!r})
from realhf_tpu_torch.base import recover
info = recover.load_safe("ex", "tr")
leaked = sorted(n for n in sys.modules if n.split(".")[0] == "realhf_tpu")
print(json.dumps(dict(type=type(info).__module__, leaked=leaked,
                      version=info.version,
                      start=info.recover_start.__dict__,
                      last=info.last_step_info.__dict__,
                      ids=info.hash_vals_to_ignore,
                      dl=info.dataloader_state,
                      manifests=info.ckpt_manifests)))
"""


def test_jax_recover_dump_loads_in_port_without_the_jax_package():
    jrecover.dump(jrecover.RecoverInfo(
        recover_start=jrecover.StepInfo(epoch=1, epoch_step=3,
                                        global_step=7),
        last_step_info=jrecover.StepInfo(epoch=1, epoch_step=2,
                                         global_step=7),
        hash_vals_to_ignore=[4, 9, "x"],
        dataloader_state=dict(epoch=1, epoch_step=2),
        ckpt_manifests={"actor": "/m.json"}), "ex", "tr")
    env = dict(os.environ, REALHF_TPU_ROOT=jconstants.ROOT_DIR)
    res = subprocess.run([sys.executable, "-c", _CHILD.format(
        repo=str(REPO))], capture_output=True, text=True, timeout=120,
        cwd=str(REPO), env=env)
    assert res.returncode == 0, res.stderr[-3000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out == dict(
        type="realhf_tpu_torch.base.recover", leaked=[],
        version=jrecover.RECOVER_INFO_VERSION,
        start=dict(epoch=1, epoch_step=3, global_step=7),
        last=dict(epoch=1, epoch_step=2, global_step=7), ids=[4, 9, "x"],
        dl=dict(epoch=1, epoch_step=2), manifests={"actor": "/m.json"})


class _Evil:
    def __reduce__(self):
        return (os.getcwd, ())


@pytest.mark.parametrize("fault", ["missing", "truncated", "garbage",
                                   "future", "foreign_class", "not_info"])
def test_recover_load_safe_degrades_to_a_fresh_start(fault):
    recover.dump(recover.RecoverInfo(), "ex", "tr")
    path = pathlib.Path(recover.dump_path("ex", "tr"))
    if fault == "missing":
        path.unlink()
    elif fault == "truncated":
        path.write_bytes(path.read_bytes()[:20])
    elif fault == "garbage":
        path.write_bytes(b"not a pickle")
    elif fault == "future":
        recover.dump(recover.RecoverInfo(version=99), "ex", "tr")
    elif fault == "foreign_class":
        path.write_bytes(pickle.dumps(_Evil()))
    else:
        path.write_bytes(pickle.dumps({"version": 1}))
    assert recover.load_safe("ex", "tr") is None


def test_recover_round_trip_and_old_schema_upgrade():
    info = recover.RecoverInfo(hash_vals_to_ignore=[1, 2])
    recover.dump(info, "ex", "tr")
    assert recover.load_safe("ex", "tr") == info
    old = recover.RecoverInfo(hash_vals_to_ignore=[3])
    for f in ("version", "buffer_state", "dataloader_state",
              "ckpt_manifests"):
        del old.__dict__[f]
    recover.dump(old, "ex", "tr")
    got = recover.load("ex", "tr")
    assert got.version == 1 and got.hash_vals_to_ignore == [3]
    assert got.ckpt_manifests is None and got.dataloader_state is None


def test_quickstart_saves_resumes_and_loads_a_path(data):
    from realhf_tpu_torch.apps.quickstart import main
    args = ["sft", "model.random_init_size=tiny", f"dataset.path={data}",
            "dataset.train_bs_n_seqs=8", "n_mbs=2", "device=cpu"]
    main(args + ["save_freq_steps=1", "recover_mode=auto",
                 "benchmark_steps=2"])
    assert recover.load("exp", "trial").last_step_info.global_step == 2
    stats = main(args + ["recover_mode=resume", "benchmark_steps=3"])
    assert np.isfinite(stats["trainDefault"]["loss"])
    # no save frequency, so only the final save dumps: after step 3
    assert recover.load("exp", "trial").last_step_info.global_step == 3
    saved = os.path.join(constants.run_save_path("exp", "trial"), "default")
    stats = main(["sft", f"model.path={saved}", "model.hf_family=llama",
                  f"dataset.path={data}", "dataset.train_bs_n_seqs=8",
                  "n_mbs=2", "device=cpu", "trial_name=frompath",
                  "benchmark_steps=1"])
    assert np.isfinite(stats["trainDefault"]["loss"])
