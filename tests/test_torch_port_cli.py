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


def test_ptxas_report_names_whole_kernel_arguments():
    """chip_smoke.py's reading of an `nvcc -Xptxas -v` log: each kernel's
    registers and spill bytes, K1 "whole"'s template arguments by name."""
    log = "\n".join([
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_121hop1_fwd_whole_"
        "kernelI13__nv_bfloat16Li4ELi2ELi2ELi2EEEvPKfS3_' for 'sm_90a'",
        "ptxas info    : Function properties for _ZN12_GLOBAL__N_1",
        "    8 bytes stack frame, 4 bytes spill stores, 12 bytes spill loads",
        "ptxas info    : Used 128 registers, 384 bytes cmem[0]",
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_121hop1_fwd_tiles_"
        "kernelIfEEvPKf' for 'sm_90a'",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 110 registers, 384 bytes cmem[0]",
    ])
    assert chip_smoke.ptxas_report(log) == [
        {"kernel": "hop1_fwd_whole_kernel", "kv": "bfloat16", "D": 128, "row_tiles": 2,
         "groups": 2, "dk_max": 16, "stack": 8, "spill_stores": 4, "spill_loads": 12,
         "registers": 128},
        {"kernel": "hop1_fwd_tiles_kernel", "kv": "float32", "stack": 0, "spill_stores": 0,
         "spill_loads": 0, "registers": 110}]


@pytest.mark.parametrize("bf16", [False, True])
def test_hop1_bound_counts_products_at_the_tensor_core_rate(bf16):
    """The hop-1 bound of chip_smoke.py at the flagship t2s launch: every
    product at the dense TF32 rate (495 TFLOP/s) over the passes "whole"
    runs it in, three (3xTF32), or two for the projection of a bfloat16 grid
    (exact in TF32): ~0.027 and ~0.021 ms, bound by operations; every
    operation at the float32 rate, ~0.066 ms."""
    nbytes, proj, wo, attn = chip_smoke.hop1_work(64, 16, 32, 40, 128, True,
                                                  2 if bf16 else 4)
    assert (proj, wo, attn) == (2_684_354_560, 1_073_741_824, 671_088_640)
    if bf16:
        ms, by = chip_smoke.bound(nbytes, tf32x3_flops=wo + attn, tf32x2_flops=proj)
        assert ms == pytest.approx((3 * (wo + attn) + 2 * proj) / 495e12 * 1e3)
        assert 0.021 < ms < 0.022
    else:
        ms, by = chip_smoke.bound(nbytes, tf32x3_flops=proj + wo + attn)
        assert ms == pytest.approx(3 * (proj + wo + attn) / 495e12 * 1e3)
        assert 0.026 < ms < 0.027
    assert by == "operations"
    f32_ms, f32_by = chip_smoke.bound(nbytes, proj + wo + attn)
    assert f32_by == "operations" and 0.065 < f32_ms < 0.067


def test_hop1_probe_marks_every_phase_of_the_whole_kernel():
    """The phase marks the probe's instrumented copy of csrc/hop1_fwd.cu
    records: HOP1_MARK(0) .. HOP1_MARK(7) once each, in order, all inside
    the whole kernel, defined to nothing unless the includer defines them,
    as the probe's source does before it includes the kernel's."""
    import re

    from bist_tpu_torch.ops import _build
    from bist_tpu_torch.tools import hop1_probe

    src = (_build.SRC_DIR / "hop1_fwd.cu").read_text()
    marks = [(int(m.group(1)), m.start()) for m in re.finditer(r"HOP1_MARK\((\d)\);", src)]
    assert [k for k, _ in marks] == list(range(len(hop1_probe.PHASES) + 1))
    start = src.index("hop1_fwd_whole_kernel(const float*")
    end = src.index("// Variant choice and launch")
    assert all(start < at < end for _, at in marks)
    assert "#ifndef HOP1_MARK\n#define HOP1_MARK(k)\n#endif" in src
    probe = hop1_probe.INSTRUMENTED
    assert probe.index("#define HOP1_MARK(k)") < probe.index('#include "hop1_fwd.cu"')


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
