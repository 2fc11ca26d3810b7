"""The port's safetensors reader and writer (``base/safetensors_io.py``)
against the ``safetensors`` package the JAX package uses: every dtype,
0-d and empty tensors, ``__metadata__``, numpy and torch inputs, the
lazy reader, and the files it must refuse (truncated, a header that runs
past the end, overlapping or inconsistent offsets), each naming the
file. Equality is of the bits: no tolerance.

Without ``ml_dtypes`` installed, bfloat16 arrays carry a
structured dtype over ``<u2``. A subprocess with ``ml_dtypes`` blocked
reads, converts and writes bfloat16 checkpoints through that form.
"""

import json
import pathlib
import subprocess
import sys

import ml_dtypes
import numpy as np
import pytest
import safetensors
import safetensors.numpy
import safetensors.torch
import torch

from realhf_tpu_torch.base import safetensors_io as st

REPO = pathlib.Path(__file__).resolve().parent.parent
DTYPES = [np.float64, np.float32, np.float16, ml_dtypes.bfloat16, np.int64,
          np.int32, np.int16, np.int8, np.uint8, np.bool_]
SHAPES = [(), (0,), (3, 0, 2), (5,), (4, 3, 2)]


def _arrays(seed=0):
    rng = np.random.default_rng(seed)
    out = {}
    for dt in DTYPES:
        for shape in SHAPES:
            name = f"t.{np.dtype(dt).name}.{'x'.join(map(str, shape)) or 's'}"
            a = np.asarray(rng.standard_normal(shape) * 100)
            out[name] = np.asarray(a > 0 if dt is np.bool_ else a.astype(dt))
    return out


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint16) if st.is_bf16(a) else a


def _assert_same(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.shape == w.shape and g.dtype == w.dtype, k
        np.testing.assert_array_equal(_bits(g), _bits(w), err_msg=k)


def test_port_writer_read_by_safetensors(tmp_path):
    want = _arrays()
    path = str(tmp_path / "a.safetensors")
    st.save_file(want, path, metadata={"format": "np", "step": "3"})
    _assert_same(safetensors.numpy.load_file(path), want)
    with safetensors.safe_open(path, framework="np") as f:
        assert f.metadata() == {"format": "np", "step": "3"}
    tt = safetensors.torch.load_file(path)
    bf = "t.bfloat16.4x3x2"
    assert tt[bf].dtype == torch.bfloat16
    np.testing.assert_array_equal(tt[bf].view(torch.int16).numpy(),
                                  want[bf].view(np.int16))


def test_safetensors_writer_read_by_port(tmp_path):
    want = _arrays(1)
    path = str(tmp_path / "b.safetensors")
    safetensors.numpy.save_file(want, path, metadata={"who": "library"})
    _assert_same(st.load_file(path), want)
    with st.SafeOpen(path) as f:
        assert f.metadata() == {"who": "library"}
        assert sorted(f.keys()) == sorted(want)
        for k in ("t.float32.s", "t.bfloat16.3x0x2", "t.int8.4x3x2"):
            np.testing.assert_array_equal(_bits(f.get_tensor(k)),
                                          _bits(want[k]))


def test_torch_tensors_in_and_out(tmp_path):
    """Tensors of any dtype (bfloat16 too) write as the library writes
    them, and read back bit for bit."""
    g = torch.Generator().manual_seed(0)
    want = {"w": torch.randn(3, 5, generator=g).to(torch.bfloat16),
            "b": torch.randn(5, generator=g),
            "i": torch.arange(6, dtype=torch.int64).reshape(2, 3)}
    path = str(tmp_path / "c.safetensors")
    st.save_file(want, path)
    lib = safetensors.torch.load_file(path)
    port = st.load_file(path)
    for k, t in want.items():
        assert torch.equal(lib[k], t), k
        assert torch.equal(st.numpy_to_tensor(port[k]), t), k


def _valid_file(tmp_path, name="v.safetensors"):
    path = tmp_path / name
    st.save_file({"a": np.arange(6, dtype=np.float32),
                  "b": np.ones((2, 2), np.int32)}, str(path))
    return path


def _rewrite_header(path, header):
    data = path.read_bytes()
    n = int.from_bytes(data[:8], "little")
    raw = json.dumps(header).encode()
    raw += b" " * (-(8 + len(raw)) % 8)
    path.write_bytes(len(raw).to_bytes(8, "little") + raw + data[8 + n:])


def _header(path):
    data = path.read_bytes()
    return json.loads(data[8:8 + int.from_bytes(data[:8], "little")])


@pytest.mark.parametrize("fault", ["truncated_data", "truncated_header",
                                   "short_length", "header_past_end",
                                   "overlap", "wrong_size", "bad_dtype"])
def test_bad_files_raise_naming_the_file(tmp_path, fault):
    path = _valid_file(tmp_path)
    data = path.read_bytes()
    if fault == "truncated_data":
        path.write_bytes(data[:-4])
    elif fault == "truncated_header":
        path.write_bytes(data[:20])
    elif fault == "short_length":
        path.write_bytes(data[:5])
    elif fault == "header_past_end":
        path.write_bytes((len(data) * 2).to_bytes(8, "little") + data[8:])
    else:
        h = _header(path)
        if fault == "overlap":
            h["b"]["data_offsets"] = [8, 24]
        elif fault == "wrong_size":
            h["a"]["shape"] = [7]
        else:
            h["a"]["dtype"] = "F33"
        _rewrite_header(path, h)
    with pytest.raises(ValueError, match=str(path.name)):
        st.load_file(str(path))


def test_overlap_is_refused_by_the_library_too(tmp_path):
    """The overlap the port refuses is one the library refuses as well
    (the planted fault is a real fault of the format)."""
    path = _valid_file(tmp_path)
    h = _header(path)
    h["b"]["data_offsets"] = [8, 24]
    _rewrite_header(path, h)
    with pytest.raises(Exception):
        safetensors.numpy.load_file(str(path))


_CHILD = r"""
import importlib.abc, json, sys
class Blocker(importlib.abc.MetaPathFinder):
    def find_spec(self, fullname, path=None, target=None):
        if fullname.split(".")[0] in ("ml_dtypes", "jax", "jaxlib"):
            raise ImportError("blocked " + fullname)
        return None
sys.meta_path.insert(0, Blocker())
sys.path.insert(0, {repo!r})
import numpy as np, torch
from realhf_tpu_torch.base import safetensors_io as st
from realhf_tpu_torch.models import hf
from realhf_tpu_torch.models.convert import params_from_numpy, params_numpy
from realhf_tpu_torch.models.hf.registry import _flatten
assert st.BF16.names == ("bfloat16",), st.BF16
d = {ckpt!r}
raw = st.load_file(d + "/model.safetensors")
cfg, eager = hf.load_hf_checkpoint(d)
_, streamed = hf.load_hf_checkpoint_streamed(d, "cpu",
                                             param_dtype="bfloat16")
eager_t = params_from_numpy(eager)
out = {{}}
for (kp, a), (_, b) in zip(_flatten(eager_t), _flatten(streamed)):
    assert a.dtype == torch.bfloat16 and torch.equal(a, b), kp
    out[".".join(kp)] = a.view(torch.int16).numpy().astype(int).tolist()
hf.save_hf_checkpoint_streamed(d + "/again", "llama", cfg, streamed)
hf.save_hf_checkpoint(d + "/again_eager", "llama", cfg, params_numpy(eager_t))
print(json.dumps(dict(raw_dtype=str(raw["model.norm.weight"].dtype),
                      leaves=out)))
"""


def test_bf16_checkpoints_without_ml_dtypes(tmp_path):
    """A bf16 llama checkpoint written by the JAX package's saver reads
    into the same bits, eager and streamed, and writes back into files
    the JAX package reads bit for bit, with ``ml_dtypes`` unimportable."""
    from realhf_tpu.models import hf as jhf
    from realhf_tpu.models.config import TransformerConfig as JConfig
    cfg = JConfig(n_layers=2, n_kv_heads=2, n_q_heads=4, hidden_dim=16,
                  intermediate_dim=24, vocab_size=40, apply_rotary=True,
                  layer_norm_type="rms", mlp_type="llama",
                  use_attention_bias=False, use_attn_proj_bias=False,
                  use_mlp_bias=False, activation_function="silu")
    rng = np.random.default_rng(2)
    shapes = {"embed": {"wte": (40, 16)}, "ln_f": {"scale": (16,)},
              "head": {"w": (16, 40)},
              "blocks": {"ln1": {"scale": (2, 16)}, "ln2": {"scale": (2, 16)},
                         "attn": {"wq": (2, 16, 16), "wk": (2, 16, 8),
                                  "wv": (2, 16, 8), "wo": (2, 16, 16)},
                         "mlp": {"wg": (2, 16, 24), "wu": (2, 16, 24),
                                 "wd": (2, 24, 16)}}}

    def draw(t):
        return {k: draw(v) if isinstance(v, dict) else
                rng.standard_normal(v).astype(ml_dtypes.bfloat16)
                for k, v in t.items()}

    params = draw(shapes)
    ckpt = str(tmp_path / "ckpt")
    jhf.save_hf_checkpoint(ckpt, "llama", cfg, params)
    res = subprocess.run(
        [sys.executable, "-c", _CHILD.format(repo=str(REPO), ckpt=ckpt)],
        capture_output=True, text=True, timeout=120, cwd=str(REPO))
    assert res.returncode == 0, res.stderr[-3000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert "bfloat16" in out["raw_dtype"]

    def flat(t, pre=""):
        for k in sorted(t):
            if isinstance(t[k], dict):
                yield from flat(t[k], pre + k + ".")
            else:
                yield pre + k, t[k]

    for name, a in flat(params):
        np.testing.assert_array_equal(
            np.asarray(out["leaves"][name], np.int64),
            a.view(np.int16).astype(np.int64), err_msg=name)
    for again in ("again", "again_eager"):
        _, back = jhf.load_hf_checkpoint(f"{ckpt}/{again}")
        for (name, a), (_, b) in zip(flat(params), flat(back)):
            assert b.dtype == ml_dtypes.bfloat16, name
            np.testing.assert_array_equal(b.view(np.uint16),
                                          a.view(np.uint16), err_msg=name)
