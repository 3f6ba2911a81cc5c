"""The port's training loop against the JAX package's, on the CPU: a
resume from the reference's checkpoint, kill and resume, preemption,
loss that falls, the MoE on a data x model mesh, the launcher, and the
``train`` phase of ``chip_smoke.py`` at a tiny size.

Configs are reduced, in float32. Losses are held within 1e-4 of the
reference's (absolute, on losses of about 5.5: the same float32
arithmetic in another library over a few AdamW steps) and within 1e-5
between two runs of the port (the same operators in the same order).
"""
import os
import shutil
import signal
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.configs import get_arch as jarch
from repro.configs import reduced as jreduced
from repro.optim import AdamWConfig as JAdamW
from repro.train import TrainConfig as JTrainConfig
from repro.train import train as jtrain
from repro_torch.configs import get_arch, reduced
from repro_torch.dist.sharding import Rules
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import StepOptions
from repro_torch.optim import AdamWConfig
from repro_torch.train import TrainConfig, latest_step, restore_checkpoint, \
    train
from torch_port_helpers import run_jax_devices
from torch_train_helpers import one_torch_thread  # noqa: F401 (autouse)

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
OPT = dict(peak_lr=1e-3, warmup_steps=1, total_steps=6)


def _train_cfg(cls, opt_cls, **kw):
    base = dict(steps=6, global_batch=4, seq_len=32, ckpt_every=2,
                log_every=100)
    base.update(kw)
    return cls(opt=opt_cls(**OPT), **base)


def test_resume_from_reference_checkpoint_equals_reference(tmp_path):
    """The reference trains llama3.2-1b (reduced, f32) for 2 steps and
    checkpoints; each package resumes from its own copy of that directory
    for 4 more steps: the same losses within 1e-4, and the port's final
    state restores in the reference's format."""
    jcfg = jreduced(jarch("llama3.2-1b"), dtype="float32")
    tcfg = reduced(get_arch("llama3.2-1b"), dtype="float32")
    ref_dir, port_dir = tmp_path / "ref", tmp_path / "port"
    first, last, _ = jtrain(jcfg, _train_cfg(JTrainConfig, JAdamW,
                                             ckpt_dir=str(ref_dir)),
                            verbose=False, max_steps_this_run=2)
    assert last == 2 and latest_step(ref_dir) == 2
    shutil.copytree(ref_dir, port_dir)
    want, jlast, _ = jtrain(jcfg, _train_cfg(JTrainConfig, JAdamW,
                                             ckpt_dir=str(ref_dir)),
                            verbose=False)
    got, tlast, (params, opt) = train(
        tcfg, _train_cfg(TrainConfig, AdamWConfig, ckpt_dir=str(port_dir)),
        verbose=False, device="cpu")
    assert jlast == tlast == 6 and len(got) == len(want) == 4
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    assert got[-1] < first[0]
    restored, step = restore_checkpoint(port_dir, {"params": params,
                                                   "opt": opt})
    assert step == 6 and int(restored["opt"]["step"]) == 6
    assert torch.equal(restored["params"]["embed"], params["embed"])


def test_kill_resume_loss_equivalence(tmp_path):
    """A preempted+resumed run reproduces the uninterrupted loss curve
    (the reference's test, on the port)."""
    cfg = reduced(get_arch("llama3.2-1b"))
    t_int = TrainConfig(steps=12, global_batch=4, seq_len=32,
                        ckpt_dir=str(tmp_path / "a"), ckpt_every=6,
                        log_every=100)
    la, _, _ = train(cfg, t_int, verbose=False, max_steps_this_run=6,
                     device="cpu")
    lb, _, _ = train(cfg, t_int, verbose=False, device="cpu")  # resumes at 6
    t_full = TrainConfig(steps=12, global_batch=4, seq_len=32,
                         ckpt_dir=str(tmp_path / "b"), ckpt_every=100,
                         log_every=100)
    lf, _, _ = train(cfg, t_full, verbose=False, device="cpu")
    assert len(la) == len(lb) == 6
    np.testing.assert_allclose(la + lb, lf, atol=1e-5)


def test_training_reduces_loss(tmp_path):
    """The reference's end-to-end check (``test_system.py``), on the port:
    dense with checkpoints, then MoE."""
    cfg = reduced(get_arch("llama3.2-1b"))
    tcfg = TrainConfig(steps=40, global_batch=8, seq_len=64,
                       ckpt_dir=str(tmp_path), ckpt_every=20, log_every=100)
    losses, last, _ = train(cfg, tcfg, verbose=False, device="cpu")
    assert last == 40 and latest_step(tmp_path) == 40
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.02, (
        losses[:5], losses[-5:])
    cfg = reduced(get_arch("granite-moe-3b-a800m"))
    tcfg = TrainConfig(steps=30, global_batch=8, seq_len=64, log_every=100)
    losses, _, _ = train(cfg, tcfg, verbose=False, device="cpu")
    assert np.mean(losses[-5:]) < np.mean(losses[:5])


MESH_REFERENCE = """
import os, shutil, sys
import numpy as np
import jax
from repro.configs import get_arch, reduced
from repro.launch.mesh import make_mesh
from repro.models import init_params
from repro.optim import AdamWConfig, init_opt_state
from repro.train import TrainConfig, save_checkpoint, train
OPT, STEPS = %r, %r
here = os.path.dirname(sys.argv[1])
cfg = reduced(get_arch("granite-moe-3b-a800m"), dtype="float32")
params = init_params(jax.random.PRNGKey(0), cfg)
save_checkpoint(os.path.join(here, "ref"), 0,
                {"params": params, "opt": init_opt_state(params)})
shutil.copytree(os.path.join(here, "ref"), os.path.join(here, "port"))
losses, last, _ = train(cfg, TrainConfig(
    steps=STEPS, global_batch=8, seq_len=32, ckpt_dir=os.path.join(here, "ref"),
    ckpt_every=100, log_every=100, opt=AdamWConfig(**OPT)),
    mesh=make_mesh((2, 2), ("data", "model")), verbose=False)
np.savez(sys.argv[2], losses=np.asarray(losses), last=last)
"""


def test_moe_on_a_data_x_model_mesh_equals_reference(tmp_path):
    """granite-moe (reduced, f32, its own capacity 1.5: tokens are dropped,
    capacity sized per data rank) on a (2, 2) data x model mesh: the
    reference's 4-device run from a step-0 checkpoint of its weights, and
    the port on a ``VirtualMesh`` of the same shape from a copy of it,
    4 steps each; the losses within 1e-4."""
    opt = dict(OPT, total_steps=4)
    ref = run_jax_devices(MESH_REFERENCE % (opt, 4), {"unused": np.zeros(1)},
                          str(tmp_path))
    cfg = reduced(get_arch("granite-moe-3b-a800m"), dtype="float32")
    mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
    got, last, _ = train(cfg, TrainConfig(
        steps=4, global_batch=8, seq_len=32, ckpt_dir=str(tmp_path / "port"),
        ckpt_every=100, log_every=100, opt=AdamWConfig(**opt)), mesh=mesh,
        verbose=False, device="cpu")
    assert last == int(ref["last"]) == 4
    np.testing.assert_allclose(got, ref["losses"], atol=1e-4, rtol=0)


def test_pallas_backend_raises_in_training():
    """``moe_backend="pallas"`` under ``train``: the first step raises
    (the kernel has no backward) on a mesh the kernel could otherwise
    take."""
    cfg = reduced(get_arch("llama4-maverick-400b-a17b"), num_experts=4,
                  experts_per_token=1, pad_to=2)
    with pytest.raises(ValueError, match="no backward"):
        train(cfg, TrainConfig(steps=1, global_batch=4, seq_len=8,
                               opts=StepOptions(moe_backend="pallas")),
              mesh=make_mesh((4,), ("data",), device="cpu"), verbose=False,
              device="cpu")
    assert Rules(make_mesh((4,), ("data",), device="cpu"), "train").kind \
        == "train"


def _launch(*args, **kw):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    return subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "llama3.2-1b", "--device", "cpu", *args], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, **kw)


def test_launcher_trains_on_the_cpu():
    out, err = _launch("--steps", "3").communicate(timeout=300)
    assert "[launch] arch=llama3.2-1b-smoke devices=1 mesh=None" in out, err
    assert "finished at step 3" in out, err


def test_sigterm_saves_and_exits(tmp_path):
    """SIGTERM mid-run: the loop checkpoints at the next step boundary and
    returns; the launcher exits 0, and the checkpoint restores."""
    proc = _launch("--steps", "100000", "--ckpt", str(tmp_path),
                   "--ckpt-every", "100000")
    try:
        for line in proc.stdout:
            if line.startswith("[train] step"):
                break
        proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=300)
    finally:
        proc.kill()
    assert proc.returncode == 0, err
    assert "preemption requested — saved at" in out
    step = latest_step(tmp_path)
    assert step is not None and 0 < step < 100000
    assert f"finished at step {step}" in out


def test_chip_smoke_train_phase_on_the_cpu():
    """Phase ``train`` at a tiny size: the three parts with every launch
    counter at 0."""
    sys.path.insert(0, ROOT)
    import chip_smoke
    got = chip_smoke.phase_train("cpu", small=True)
    assert got == {}                  # no kernel launched
    dense, moe, resume = (chip_smoke.train_configs()[k] for k in (
        "dense", "moe", "resume"))
    assert (dense.num_layers, dense.d_model, dense.vocab_size,
            dense.tie_embeddings, dense.dtype) == (16, 2048, 128256, True,
                                                   "bfloat16")
    assert (moe.num_layers, moe.d_model, moe.num_heads, moe.num_kv_heads,
            moe.num_experts_padded, moe.experts_per_token, moe.moe_d_ff,
            moe.vocab_size) == (8, 1536, 24, 8, 48, 8, 512, 49155)
    assert (resume.num_layers, resume.d_model, resume.num_experts,
            resume.experts_per_token, resume.vocab_size) == (8, 512, 8, 2,
                                                             32000)
