"""The port's training launcher end to end on the CPU at a small size:
``python -m repro_torch.launch.train --dsekl --device cpu`` trains, prints
its per-epoch validation errors and the JAX launcher's summary lines, and
refuses the modes the port does not have yet, naming them.  ``--execution
mesh`` runs (a world of one here; tests/test_torch_mesh_fit.py drives 4
ranks under torch.distributed.run).  The LM path (``--arch granite-20b
--steps 4 --device cpu``) trains, checkpoints and ``--resume``s,
deepseek-v3 (MLA) trains at its reduced widths; a ``--full`` model larger
than the device in a world of one exits naming the production mesh and
its world size, ``--full`` in a small world raises naming the size it
needs, and the configs with a frontend, which the launcher (as JAX's)
does not build, are refused.  Under ``torch.distributed.run`` the LM
trains granite on a (2, 2) mesh of four gloo ranks: rank 0 alone prints,
and its losses are the single-device launcher's on the same seed."""
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

from repro_torch.checkpoint import read_checkpoint
from repro_torch.launch import train

ROOT = pathlib.Path(__file__).resolve().parents[1]
SMALL = ["--dsekl", "--device", "cpu", "--n", "2048", "--epochs", "2",
         "--n-grad", "128", "--n-expand", "128"]


def test_train_cli_runs_end_to_end():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                          *SMALL], env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.splitlines()
    assert sum(line.startswith("[dsekl] epoch") and "val_err=" in line
               for line in lines) == 2
    assert any(line.startswith("[train-dsekl] 2 epochs in") for line in lines)
    assert any(line.startswith("[train-dsekl] val error") for line in lines)


def test_train_dsekl_result_and_hold_out(capsys):
    args = train.parser().parse_args(SMALL)
    out = train.train_dsekl(args)
    res = out["result"]
    n_val = max(min(2048, 2048 // 8), 1)
    assert out["x_val"].shape == (n_val, 54)
    assert out["x"].shape == (2048 - n_val, 54)
    assert int(res.state.step) == 2 * ((2048 - n_val) // 128)
    assert out["cfg"].schedule == "adagrad" and out["cfg"].lam == 1e-4
    assert out["cfg"].loss == "hinge"
    errs = [h["val_error"] for h in res.history]
    assert len(errs) == 2 and all(0.0 <= e <= 1.0 for e in errs)
    assert "val error" in capsys.readouterr().out


# --data mmap, --algorithm parallel, --precondition-k, --execution bcd and
# --execution mesh are ported (tests/test_torch_hosted.py,
# test_torch_precond.py, test_torch_bcd.py and test_torch_mesh_fit.py drive
# them).  BCD over the memmap runs, and so does the mesh, with EigenPro or
# without (a world of one: the launcher's default mesh is 1 x 1);
# --precondition-k with --execution bcd is refused at parse time, naming
# the refusal (``named`` None: the command runs).
@pytest.mark.parametrize("extra,named", [
    pytest.param(["--data", "mmap", "--execution", "bcd"], None,
                 id="extra0---data mmap"),
    pytest.param(["--algorithm", "parallel", "--precondition-k", "8",
                  "--execution", "mesh"],
                 None, id="extra1---algorithm parallel"),
    pytest.param(["--execution", "mesh"], None,
                 id="extra2---execution mesh"),
    pytest.param(["--precondition-k", "8", "--execution", "bcd"],
                 "--precondition-k with --execution bcd",
                 id="extra3---precondition-k"),
])
def test_unported_modes_exit_naming_them(extra, named, capsys, tmp_path):
    argv = SMALL + extra + ["--mmap-dir", str(tmp_path)]
    if named is None:
        import torch.distributed as dist
        train.main(argv)
        lines = capsys.readouterr().out.splitlines()
        assert sum(ln.startswith("[dsekl] epoch") and "val_err=" in ln
                   for ln in lines) == 2
        if "mesh" in extra:
            assert any("(mesh; mesh data 1 x model 1, gloo" in ln
                       for ln in lines)
            assert ("--precondition-k" in extra) == any(
                "EigenPro: k=8" in ln for ln in lines)
            assert not dist.is_initialized()
            return
        assert any("(bcd rounds, prefetch;" in ln for ln in lines)
        assert (tmp_path / "manifest.json").is_file()
        return
    with pytest.raises(SystemExit) as exc:
        train.main(argv)
    assert exc.value.code != 0
    err = capsys.readouterr().err
    refusal = [ln for ln in err.splitlines() if "not ported" in ln]
    if named.startswith("--precondition-k"):
        assert not refusal and named in err
        assert "stochastic step only" in err
        return
    assert len(refusal) == 1 and named in refusal[0]
    assert "--precondition-k" not in refusal[0]


LM = ["--arch", "granite-20b", "--device", "cpu", "--batch", "2",
      "--seq", "16"]


@pytest.mark.parametrize("extra,named", [
    (["--arch", "kimi-k2-1t-a32b", "--full"], "--full kimi-k2-1t-a32b"),
])
def test_lm_path_is_refused(extra, named, capsys):
    """A ``--full`` model larger than the one device of a world of one
    exits, naming the production mesh and the world it needs."""
    with pytest.raises(SystemExit) as exc:
        train.main(LM + ["--steps", "1"] + extra)
    assert exc.value.code != 0
    err = capsys.readouterr().err
    assert named in err
    assert "production mesh (16, 16): a world of 256 ranks" in err


def test_multi_pod_names_the_production_mesh(capsys):
    with pytest.raises(SystemExit) as exc:
        train.main(LM + ["--steps", "1", "--multi-pod"])
    assert exc.value.code != 0
    assert "--multi-pod names the production mesh" in capsys.readouterr().err


@pytest.mark.parametrize("extra,need", [([], 256), (["--multi-pod"], 512)])
def test_full_in_a_small_world_raises_naming_its_size(monkeypatch, extra,
                                                      need):
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(ValueError, match=f"needs a world of {need} ranks"):
        train.main(LM + ["--steps", "1", "--full"] + extra)


@pytest.mark.distributed
def test_lm_trains_on_a_mesh_under_torchrun(tmp_path):
    """granite on (2, 2): four gloo ranks, rank 0 alone prints, and the
    losses equal the single-device launcher's (the same seed, weights
    and batches) within the float32 tolerance; the checkpoint it writes
    is the single-device layout."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.pop("WORLD_SIZE", None)
    argv = LM[2:] + ["--batch", "4", "--steps", "3", "--ckpt-every", "3"]
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "4", "-m", "repro_torch.launch.train",
         "--arch", "granite-20b", "--device", "cpu", "--data-par", "2",
         "--model-par", "2", "--dist-backend", "gloo", "--ckpt-dir",
         str(tmp_path / "mesh"), *argv],
        env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.splitlines()
    head = [ln for ln in lines if ln.startswith("[launch] arch=")]
    assert len(head) == 1 and "mesh 2 x 2 (gloo)" in head[0], lines
    steps = [ln for ln in lines if ln.startswith("[train] step")]
    assert len(steps) == 1, lines                    # step 0, rank 0 alone
    done = [ln for ln in lines if ln.startswith("[launch] done: loss")]
    assert len(done) == 1
    one = train.train_lm(train.parser().parse_args(
        LM + ["--arch", "granite-20b", "--ckpt-dir", str(tmp_path / "one"),
              *argv]))
    want = [h["loss"] for h in one["history"]]
    assert done[0] == (f"[launch] done: loss {want[0]:.4f} -> "
                       f"{want[-1]:.4f}")
    _, mesh, _ = read_checkpoint(tmp_path / "mesh")
    _, flat, _ = read_checkpoint(tmp_path / "one")
    assert sorted(mesh) == sorted(flat)
    for k, v in flat.items():
        scale = max(1.0, float(np.abs(v).max()))
        np.testing.assert_allclose(mesh[k], v, rtol=1e-4,
                                   atol=(1e-3 if k.startswith("opt/")
                                         else 1e-4) * scale, err_msg=k)


@pytest.mark.parametrize("name", ["llama-3.2-vision-11b", "whisper-tiny"])
def test_lm_launcher_refuses_a_config_with_a_frontend(name, capsys):
    """JAX's launcher builds no frontend for the cross-attention configs;
    the port's says so rather than inventing one."""
    with pytest.raises(SystemExit) as exc:
        train.main(LM + ["--steps", "1", "--arch", name])
    assert exc.value.code != 0
    err = capsys.readouterr().err
    assert name in err and "frontend" in err and "builds none" in err


def test_lm_launcher_trains_deepseek_at_reduced_widths(tmp_path):
    args = train.parser().parse_args(LM + [
        "--arch", "deepseek-v3-671b", "--steps", "2", "--ckpt-dir",
        str(tmp_path), "--ckpt-every", "2"])
    assert train.lm_refusal(args) == ""
    res = train.train_lm(args)
    assert res["cfg"].use_mla and res["cfg"].name == "deepseek-v3-671b"
    assert [h["step"] for h in res["history"]] == [0, 1]
    assert all(np.isfinite(h["loss"]) for h in res["history"])


def test_lm_trains_checkpoints_and_resumes(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    base = [sys.executable, "-m", "repro_torch.launch.train",
            "--arch", "granite-20b", "--device", "cpu", "--ckpt-dir",
            str(tmp_path), "--ckpt-every", "2"]
    out = subprocess.run(base + ["--steps", "4"], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "[launch] arch=granite-20b" in out.stdout
    assert "[launch] done: loss" in out.stdout
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "step_0000000002", "step_0000000004"]
    args = train.parser().parse_args(LM + [
        "--steps", "6", "--ckpt-dir", str(tmp_path), "--ckpt-every", "2",
        "--resume"])
    res = train.train_lm(args)
    assert [h["step"] for h in res["history"]] == [4, 5]
    assert int(res["opt_state"]["count"]) == 6
    assert all(np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"])
               for h in res["history"])
