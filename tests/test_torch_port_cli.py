"""The port as a user meets it, on the CPU: the generate CLI end to end on a
tiny on-disk dataset (chip_smoke.py's own writer, at a tiny width), the
entry points' CUDA default, and a package that imports neither JAX nor the
JAX package."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import chip_smoke
from bist_tpu.config import load_conf as jax_load_conf
from bist_tpu_torch.cli import generate
from bist_tpu_torch.config import load_conf
from bist_tpu_torch.weights import load_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(d_model=32, att_h=4, nb_blocks=2, nb_venc_blocks=2, nb_cenc_blocks=2)


def run(args, timeout=300):
    return subprocess.run([sys.executable] + args, cwd=REPO, capture_output=True,
                          text=True, timeout=timeout)


def test_generate_cli_end_to_end_on_cpu(tmp_path):
    root = str(tmp_path / "tiny")
    out = chip_smoke.phase_cli(torch.device("cpu"), root, n_dialogs=5,
                               model_kw=TINY, dv=24, s=4, t_max=9)
    assert out["dialogs"] == 5 and all(out["answers"])
    # the .conf is the JAX package's format too; the .pt holds the JAX tree
    vocab, cfg, _, _ = load_conf(os.path.join(root, "mtn.conf"))
    jvocab, jcfg, _, _ = jax_load_conf(os.path.join(root, "mtn.conf"))
    assert vocab == jvocab and cfg.d_model == jcfg.d_model == 32
    params = load_params(os.path.join(root, "mtn.pt"), "cpu")
    assert params["embed"]["lut"].shape == (len(vocab), 32)


def test_entry_points_default_to_cuda(capsys):
    """Without a card, the CLI raises unless the CPU is asked for, and
    chip_smoke.py exits non-zero and prints no result."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        generate.main(["--decode-style", "beam_search", "--model", "absent"])
    capsys.readouterr()
    assert chip_smoke.main() != 0
    out = capsys.readouterr().out
    assert '"ok"' not in out and '"kernels"' not in out


@pytest.mark.parametrize("args", [
    ["--decode-style", "greedy"],
    ["--decode-style", "beam_search", "--ensemble", "other"],
])
def test_unported_options_raise(args):
    with pytest.raises(SystemExit, match="not ported"):
        generate.main(args + ["--device", "cpu"])


def test_package_imports_neither_jax_nor_bist_tpu():
    code = (
        "import importlib, pkgutil, sys\n"
        "import bist_tpu_torch, chip_smoke\n"
        "for m in pkgutil.walk_packages(bist_tpu_torch.__path__, 'bist_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'bist_tpu'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    r = run(["-c", code])
    assert r.returncode == 0, r.stdout + r.stderr


def test_result_schema_check_rejects_placeholder_answers():
    orig = {"dialogs": [{"image_id": "v", "dialog": [
        {"question": "q ?", "answer": "__UNDISCLOSED__"}]}]}
    good = {"dialogs": [{"image_id": "v", "dialog": [
        {"question": "q ?", "answer": "a man"}]}]}
    chip_smoke.check_result_schema(good, orig)
    bad = json.loads(json.dumps(good))
    bad["dialogs"][0]["dialog"][0]["answer"] = "__UNDISCLOSED__"
    with pytest.raises(AssertionError, match="bad answer"):
        chip_smoke.check_result_schema(bad, orig)
    assert np.isfinite(chip_smoke.bound(1e9, 1e12)[0])


def test_chip_smoke_phases_on_cpu(monkeypatch):
    """chip_smoke.py's main path and mha phases at a small batch on the CPU,
    where the wrappers run their plain versions (no launches)."""
    from bist_tpu_torch.ops import dispatch

    cpu = torch.device("cpu")
    main = chip_smoke.phase_main_path(cpu, n_batches=1, B=4)
    assert main["launches"] == {"hop1_fwd": 0, "flash_fwd": 0}
    assert main["first_best_identical_share"] == 1.0
    assert main["ctx_max_abs_diff"] <= 2e-4
    monkeypatch.setattr(dispatch, "FLASH_MIN_KV", 0)
    mha = chip_smoke.phase_mha_flash(cpu, B=1, Lk=300)
    assert mha["launches"] == 0 and mha["max_abs_err"] <= 2e-4
