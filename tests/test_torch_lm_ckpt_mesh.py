"""LM training checkpoints across mesh shapes and one device, through
``train_loop`` (``repro_torch/train/loop.py``) on the CPU: reduced mamba2
(ZeRO'd "embed" dims, model-split SSM heads and a conv weight whose B / C
tail is whole on every rank), AdamW, B 4, S 16, 4 steps with a checkpoint
every 2.

A mesh checkpoint is the single-device one: every rank gathers its slices
of the parameters and moments whole, rank 0 writes, and a resume takes
each rank's slices (``nn.module.gather_whole`` / ``take_local``).  One
local world of 4 gloo ranks (``torch_mesh_ranks.lm_ckpt_cases``):

* (2, 2) checkpointed at step 2 and resumed on (2, 2) to step 4 equals
  the uninterrupted (2, 2) run bit for bit (checkpoint and losses);
* the same checkpoint resumed on (4, 1), and on one device in this
  process, equals the uninterrupted run within the float32 tolerance
  (rtol 1e-4, atol 1e-4 x max(1, |oracle|_inf); Adam's moments at atol
  1e-3 x |oracle|_inf: the updates divide by their square roots);
* a one-device checkpoint at step 2 resumed on (2, 2) equals the
  uninterrupted one-device run within the same tolerance;
* the files are the single-device layout: the keys and shapes of the
  one-device checkpoint's.
"""
import os
import shutil

import numpy as np
import pytest
import torch

import torch_mesh_ranks as ranks
from repro_torch.checkpoint import CheckpointManager, read_checkpoint
from repro_torch.data import BigramPipeline
from repro_torch.launch.mesh import spawn_world
from repro_torch.optim import make_optimizer, make_schedule
from repro_torch.train import (TrainLoopConfig, make_train_step,
                               train_loop, trainable)

CASE = {"name": "mamba2-780m", "changes": {}}
STEPS, HALF = 4, 2


def _one_device(directory, n_steps, resume):
    model = ranks._seeded_lm(CASE)
    params = trainable(model)
    opt = make_optimizer("adamw", make_schedule(
        "cosine", 3e-3, warmup_steps=1, total_steps=STEPS))
    step = make_train_step(model, opt, loss_chunks=4)
    pipe = BigramPipeline(model.cfg.vocab_size, 4, 16, seed=1)
    res = train_loop(step, params, opt.init(params), pipe,
                     CheckpointManager(directory, keep=5),
                     TrainLoopConfig(n_steps=n_steps, ckpt_every=2),
                     resume=resume, device="cpu")
    return [h["loss"] for h in res["history"]]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("ckpt_mesh"))
    one = _one_device(os.path.join(root, "one"), STEPS, False)
    _one_device(os.path.join(root, "o1"), HALF, False)
    res = spawn_world(ranks.lm_ckpt_cases, 4, (root, CASE, STEPS, HALF),
                      timeout_s=300, workdir=root)
    shutil.copytree(os.path.join(root, "s22"), os.path.join(root, "r1"))
    r1 = _one_device(os.path.join(root, "r1"), STEPS, True)

    def ck(name, step=STEPS):
        return read_checkpoint(os.path.join(root, name), step)[1]

    return {"losses": dict(res[0], one=one, r1=r1), "ranks": res,
            "ck": ck}


def _close(got, want, what, atol=1e-4):
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=atol * scale,
                               err_msg=what)


def _hold(got, want, exact=False):
    assert set(got) == set(want)
    for k, w in want.items():
        assert got[k].shape == w.shape, k
        if exact:
            np.testing.assert_array_equal(got[k], w, err_msg=k)
        elif k != "opt/count":
            _close(got[k], w, k, atol=1e-3 if k.startswith("opt/v/")
                   or k.startswith("opt/m/") else 1e-4)
        else:
            assert int(got[k]) == int(w)


@pytest.mark.distributed
def test_mesh_checkpoint_resumes_bit_for_bit_on_the_same_shape(runs):
    _hold(runs["ck"]("r22"), runs["ck"]("u22"), exact=True)
    losses = runs["losses"]
    assert losses["r22"] == losses["u22"][HALF:]
    for r in range(4):            # every rank logs the step's loss
        assert runs["ranks"][r]["u22"] == losses["u22"]


@pytest.mark.distributed
def test_mesh_checkpoint_resumes_on_another_mesh_shape(runs):
    _hold(runs["ck"]("r41"), runs["ck"]("u22"))
    _close(np.array(runs["losses"]["r41"]),
           np.array(runs["losses"]["u22"][HALF:]), "losses")


@pytest.mark.distributed
def test_mesh_checkpoint_resumes_on_one_device(runs):
    _hold(runs["ck"]("r1"), runs["ck"]("u22"))
    _close(np.array(runs["losses"]["r1"]),
           np.array(runs["losses"]["u22"][HALF:]), "losses")


@pytest.mark.distributed
def test_one_device_checkpoint_resumes_on_a_mesh(runs):
    _hold(runs["ck"]("o1"), runs["ck"]("one"))
    _close(np.array(runs["losses"]["o22"]),
           np.array(runs["losses"]["one"][HALF:]), "losses")


@pytest.mark.distributed
def test_mesh_checkpoint_is_the_single_device_layout(runs):
    mesh, one = runs["ck"]("s22", HALF), runs["ck"]("o1", HALF)
    assert sorted(mesh) == sorted(one)
    assert all(mesh[k].shape == one[k].shape and mesh[k].dtype ==
               one[k].dtype for k in one)
    # The uninterrupted mesh run and one device: the same training.
    _hold(runs["ck"]("u22"), runs["ck"]("one"))
    assert any(torch.from_numpy(v).numel() > 1 for v in mesh.values())
