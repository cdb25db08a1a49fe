"""The port's training entry points on the CPU: `python -m
bist_tpu_torch.cli.train --device cpu` for one epoch on a tiny on-disk
dataset, its artifacts and `cli.generate` from its best checkpoint
(chip_smoke.py's phase 7, at a tiny width), chip_smoke.py's training phase
at a tiny width, and the CLI's CUDA default and unported options."""

import os

import pytest
import torch

import chip_smoke
from bist_tpu.config import load_conf as jax_load_conf
from bist_tpu_torch.cli import train
from bist_tpu_torch.weights import load_params
from torch_threads import two_threads  # noqa: F401 (autouse)

TINY = dict(d_model=32, att_h=4, nb_blocks=2, nb_venc_blocks=2, nb_cenc_blocks=2)


def test_train_cli_then_generate_on_cpu(tmp_path):
    root = str(tmp_path / "tiny")
    out = chip_smoke.phase_train_cli(torch.device("cpu"), root, n_dialogs=4,
                                     model_kw=TINY, dv=24, s=4, t_max=9)
    assert [r.split(",")[1] for r in out["trace"]] == ["train", "val"]
    assert all(out["answers"])
    model = os.path.join(root, "exp", "mtn")
    _, jcfg, jtcfg, extra = jax_load_conf(model + ".conf")     # the JAX format too
    assert jcfg.d_model == 32 and jcfg.dropout == 0.0 and extra["fea_type"] == ["resnext_st"]
    params = load_params(model + "_best.pt", "cpu")
    assert params["embed"]["lut"].shape[1] == 32
    ckpt = torch.load(model + "_best.pt", weights_only=True)
    assert set(ckpt) == {"params", "opt_state", "step", "meta"} and ckpt["step"] > 0


def test_chip_smoke_training_phase_on_cpu():
    """chip_smoke.py's training phase at a tiny width on the CPU, where the
    wrappers run their plain versions (no launches)."""
    out = chip_smoke.phase_train(torch.device("cpu"), steps=3, B=4, model_kw=TINY)
    assert out["launches"] == {"hop1_fwd": 0, "hop1_bwd": 0}
    assert out["hop1_variants"] == out["hop1_bwd_variants"] == {}
    assert out["grad_check"]["loss_rel_diff"] <= 5e-4
    assert out["loss_last_same_batch"] < out["loss_first"]


def test_train_cli_defaults_to_cuda_and_rejects_unported_options():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--model", "absent"])
    # data parallelism is ported (tests/test_torch_parallel_cli.py); what
    # it still refuses: microbatches that do not split over the ranks
    with pytest.raises(SystemExit, match="grad-accum x ranks"):
        train.main(["--num-devices", "2", "--grad-accum", "2", "--batch-size", "6",
                    "--device", "cpu"])
    with pytest.raises(SystemExit, match="no reference-format .conf"):
        train.main(["--init-from-ref", "ref", "--device", "cpu"])
    with pytest.raises(SystemExit, match="no such directory"):
        train.main(["--init-from-ref", "ref", "--reference-root", "/nonexistent",
                    "--device", "cpu"])
