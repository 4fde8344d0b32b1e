"""The port's npz checkpoints against the JAX package's format: a
``TrainState`` with a bf16 leaf round-trips bit for bit, a checkpoint the
JAX package writes loads into the port and one the port writes loads in
the JAX package's ``load``, both equal bit for bit to the state the other
side holds, and a missing or extra key raises. Then the training launcher
on the CPU (``python -m repro_torch.launch.train --device cpu``): a few
steps of a reduced arch with ``--ckpt``, then ``--resume`` from it, with
finite losses and the optimizer step carried over; without ``--device``
it raises when there is no CUDA.
"""
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch_parity import jax_cfg_f32, torch_cfg

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.train import checkpoint as JCKPT  # noqa: E402
from repro.train import loop as JLOOP  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.launch import train as launcher  # noqa: E402
from repro_torch.train import checkpoint as TCKPT  # noqa: E402
from repro_torch.train import loop as TLOOP  # noqa: E402
from repro_torch.train.optimizer import AdamWState, leaves  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ARCH = "chatglm3-6b"


def _cfg():
    return torch_cfg(tconfigs.get_reduced(ARCH), torch.float32)


def _port_state(seed, step=0):
    """A reduced train state with its embedding in bf16 and moments that
    are not zero."""
    st = TLOOP.make_train_state(_cfg(), torch.Generator().manual_seed(seed),
                                "cpu")
    st.params["embed"] = st.params["embed"].to(torch.bfloat16)
    g = torch.Generator().manual_seed(seed + 1)
    for m in leaves((st.opt.mu, st.opt.nu)):
        m.copy_(torch.rand(m.shape, generator=g))
    return st._replace(opt=st.opt._replace(
        step=torch.tensor(step, dtype=torch.int32)))


def _bits(t):
    return t.detach().cpu().reshape(-1).view(torch.uint8).numpy().tobytes()


def test_train_state_round_trips_bit_for_bit(tmp_path):
    path = str(tmp_path / "sub" / "state.npz")
    saved = _port_state(0, step=7)
    TCKPT.save(path, saved)
    assert os.path.exists(path) and not os.path.exists(path + ".tmp.npz")
    got = TCKPT.load(path, _port_state(5))
    assert int(got.opt.step) == 7 and got.opt.step.dtype == torch.int32
    assert got.params["embed"].dtype == torch.bfloat16
    for a, b in zip(leaves(got), leaves(saved), strict=True):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert _bits(a) == _bits(b)


def _jax_to_torch(a):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _jax_state():
    """The JAX package's train state of the same reduced arch, with its
    embedding in bf16, step 3 and moments that are not zero."""
    jc = jax_cfg_f32(jconfigs.get_reduced(ARCH))
    st = JLOOP.make_train_state(jc, jax.random.PRNGKey(0))
    params = dict(st.params, embed=st.params["embed"].astype(jnp.bfloat16))
    mu = jax.tree.map(lambda a: a + 0.5, st.opt.mu)
    return JLOOP.TrainState(params, st.opt._replace(
        step=jnp.asarray(3, jnp.int32), mu=mu))


def _as_port(jstate):
    """The JAX state's values in the port's structure (field for field)."""
    conv = lambda t: jax.tree.map(_jax_to_torch, t)  # noqa: E731
    return TLOOP.TrainState(conv(jstate.params), AdamWState(
        _jax_to_torch(jstate.opt.step), conv(jstate.opt.mu),
        conv(jstate.opt.nu)))


def test_jax_checkpoint_loads_in_the_port(tmp_path):
    path = str(tmp_path / "jax.npz")
    jstate = _jax_state()
    JCKPT.save(path, jstate)
    got = TCKPT.load(path, _port_state(1))
    want = _as_port(jstate)
    assert int(got.opt.step) == 3
    for a, b in zip(leaves(got), leaves(want), strict=True):
        assert a.dtype == b.dtype and _bits(a) == _bits(b)


def test_port_checkpoint_loads_in_jax(tmp_path):
    path = str(tmp_path / "port.npz")
    jstate = _jax_state()
    TCKPT.save(path, _as_port(jstate))
    got = JCKPT.load(path, jstate)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(jstate),
                    strict=True):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def test_missing_or_extra_key_raises(tmp_path):
    path = str(tmp_path / "state.npz")
    TCKPT.save(path, _port_state(0))
    more = _port_state(0)
    more.params["extra"] = torch.zeros(2)
    with pytest.raises(KeyError, match="missing=\\['params/extra'\\]"):
        TCKPT.load(path, more)
    fewer = _port_state(0)
    del fewer.params["final_norm"]
    with pytest.raises(KeyError, match="extra=\\['params/final_norm'\\]"):
        TCKPT.load(path, fewer)
    wrong = _port_state(0)
    wrong.params["final_norm"] = torch.zeros(3)
    with pytest.raises(ValueError, match="params/final_norm"):
        TCKPT.load(path, wrong)


def _run_launcher(*args):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu",
         "--arch", ARCH, "--batch", "2", "--seq", "16", "--log-every", "1",
         *args], env=env, cwd=ROOT, capture_output=True, text=True,
        timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    steps = re.findall(r"step +(\d+)  loss (\S+)  gnorm (\S+)  lr (\S+)",
                       out.stdout)
    return out.stdout, [(int(s), float(lo), float(g), float(lr))
                        for s, lo, g, lr in steps]


def test_launcher_trains_checkpoints_and_resumes_on_cpu(tmp_path):
    ckpt = str(tmp_path / "c.npz")
    text, steps = _run_launcher("--steps", "3", "--ckpt", ckpt)
    assert text.startswith(f"arch={ARCH} params=")
    assert f"checkpoint -> {ckpt}" in text
    assert [s for s, *_ in steps] == [0, 1, 2]
    assert all(np.isfinite([lo, g]).all() for _, lo, g, _ in steps)
    state = TCKPT.load(ckpt, TLOOP.make_train_state(
        tconfigs.get_reduced(ARCH), torch.Generator().manual_seed(1), "cpu"))
    assert int(state.opt.step) == 3
    _, resumed = _run_launcher("--steps", "2", "--resume", ckpt)
    assert all(np.isfinite([lo, g]).all() for _, lo, g, _ in resumed)
    # the schedule goes on from the restored step: lr(4) = 3e-4 * 4 / 100
    assert resumed[0][3] == pytest.approx(1.2e-5, rel=1e-2)
    assert steps[0][3] == pytest.approx(3e-6, rel=1e-2)


def test_launcher_defaults_to_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        launcher.main(["--arch", ARCH, "--steps", "1"])
