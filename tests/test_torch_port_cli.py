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
from torch_threads import two_threads  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(d_model=32, att_h=4, nb_blocks=2, nb_venc_blocks=2, nb_cenc_blocks=2)


def run(args, timeout=300):
    return subprocess.run([sys.executable] + args, cwd=REPO, capture_output=True,
                          text=True, timeout=timeout)


def test_generate_cli_end_to_end_on_cpu(tmp_path):
    """Every decode style through the CLI on --device cpu, each result JSON
    in the JAX CLI's schema (chip_smoke.check_result_schema): greedy at the
    defaults (no --decode-style), beam search, a 2-model ensemble, sampling
    and oracle on the labeled turns."""
    root = str(tmp_path / "tiny")
    out = chip_smoke.phase_cli(torch.device("cpu"), root, n_dialogs=5,
                               model_kw=TINY, dv=24, s=4, t_max=9)
    assert out["dialogs"] == 5
    assert set(out["answers"]) == {"greedy (default)", "beam_search",
                                   "beam_search ensemble of 2", "sample", "oracle"}
    assert all(out["answers"]["beam_search"])
    assert len(out["answers"]["greedy (default)"]) == 5
    assert len(out["answers"]["oracle"]) > 5          # every labeled turn
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


@pytest.mark.parametrize("args,match", [
    (["--reference-root", "/nonexistent"], "not read"),
    (["--decode-style", "nucleus"], "not one of"),
])
def test_unported_options_raise(args, match):
    with pytest.raises(SystemExit, match=match):
        generate.main(args + ["--device", "cpu"])


@pytest.mark.parametrize("args,match", [
    (["--decode-style", "oracle", "--undisclosed-only", "1"], "requires labeled"),
    (["--decode-style", "greedy", "--ensemble", "other"], "only supported with"),
])
def test_jax_cli_guards_exit(args, match):
    """The two guards of bist_tpu's CLI, before any model is read: oracle
    needs labeled turns, and an ensemble decodes by beam search only."""
    with pytest.raises(SystemExit, match=match):
        generate.main(args + ["--device", "cpu", "--model", "absent"])


def test_default_decode_style_is_greedy():
    assert generate.build_parser().parse_args([]).decode_style == "greedy"
    assert set(generate.PORTED_STYLES) == {"beam_search", "greedy", "oracle", "sample"}


def test_package_imports_neither_jax_nor_bist_tpu():
    code = (
        "import importlib, pkgutil, sys\n"
        "import bist_tpu_torch, chip_smoke\n"
        "for m in pkgutil.walk_packages(bist_tpu_torch.__path__, 'bist_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'bist_tpu'))\n"
        "required = ['bist_tpu_torch.models.resnext3d', 'bist_tpu_torch.models.backbones3d',\n"
        "            'bist_tpu_torch.cli.extract_features',\n"
        "             'bist_tpu_torch.cli.generate_result_video',\n"
        "             'bist_tpu_torch.tasks.tgifqa', 'bist_tpu_torch.cli.train_tgif',\n"
        "             'bist_tpu_torch.parallel.mesh', 'bist_tpu_torch.parallel.multihost']\n"
        "bad += [m for m in required if m not in sys.modules]\n"
        "from bist_tpu_torch.models import resnext3d\n"
        "bad += [n for n in ('STEM_S2D', 'GROUP_CH') if hasattr(resnext3d, n)]\n"
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


def test_ptxas_report_names_flash_kernel_arguments():
    """K3's kernel in chip_smoke.py's reading of a ptxas log: its mode (kv
    split, column split, column blocks), 8-row kv tiles a scoring warp and
    most output tiles a warp."""
    name = ("_ZN12_GLOBAL__N_13mma20flash_fwd_mma_kernelI{}Lb{}ELi{}ELi{}ELb{}EEEvNS0_4Args"
            "IT_EE")
    log = "\n".join(
        f"ptxas info    : Compiling entry function '{name.format(*args)}' for 'sm_90a'\n"
        f"    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        f"ptxas info    : Used {regs} registers, used 1 barriers"
        for args, regs in ((("13__nv_bfloat16", 1, 2, 8, 0), 96), (("f", 0, 1, 8, 0), 117),
                           (("f", 0, 1, 8, 1), 120)))
    rows = chip_smoke.ptxas_report(log)
    assert rows[0] == {"kernel": "flash_fwd_mma_kernel", "kv": "bfloat16", "mode": "kv split",
                       "score_tiles": 2, "out_tiles_max": 8, "stack": 0, "spill_stores": 0,
                       "spill_loads": 0, "registers": 96}
    assert [(r["kv"], r["mode"], r["registers"]) for r in rows[1:]] == [
        ("float32", "column split", 117), ("float32", "column blocks", 120)]


@pytest.mark.parametrize("bf16", [False, True])
def test_flash_bound_at_the_mha_shape_is_bytes(bf16):
    """K3's bound in chip_smoke.py at mha's shape (G128 Lq32 Lk32768 d64,
    masked): q, k, v and the mask read once, 0.647 ms at 3.35 TB/s (0.326
    ms for a bfloat16 grid), above the 3xTF32 products' 0.21 ms (two
    passes on a bfloat16 grid: 0.139) and the float32 rate's 0.51 ms."""
    nbytes, flops = chip_smoke.flash_work(128, 32, 32768, 64, True, 2 if bf16 else 4)
    assert flops == 34_359_738_368
    if bf16:
        ms, by = chip_smoke.bound(nbytes, tf32x2_flops=flops)
        assert 0.325 < ms < 0.326
    else:
        ms, by = chip_smoke.bound(nbytes, tf32x3_flops=flops)
        assert 0.646 < ms < 0.648
    assert by == "bytes"
    assert chip_smoke.bound(0, tf32x3_flops=flops)[0] == pytest.approx(0.2082, abs=1e-4)
    assert chip_smoke.bound(0, tf32x2_flops=flops)[0] == pytest.approx(0.1388, abs=1e-4)
    assert chip_smoke.bound(0, flops)[0] == pytest.approx(0.5128, abs=1e-4)


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


@pytest.mark.parametrize("bf16", [False, True])
def test_hop1_bwd_bound_counts_products_at_the_tensor_core_rate(bf16):
    """K2's bound in chip_smoke.py at the flagship t2s training launch (B32
    G16 Lq32 Lk40 D128 h8): every product at the dense TF32 rate over the
    passes "whole" runs it in, three (3xTF32), or two for the products with
    a bfloat16 grid as an operand (the K/V recompute and dW): ~0.0295 and
    ~0.0241 ms, bound by operations; every operation at the float32 rate,
    ~0.0726 ms."""
    nbytes, flops, kv_flops = chip_smoke.hop1_bwd_work(32, 16, 32, 40, 128, 8, True,
                                                       2 if bf16 else 4)
    assert flops == 4_865_392_640 and kv_flops == 2_684_354_560
    if bf16:
        ms, by = chip_smoke.bound(nbytes, tf32x3_flops=flops - kv_flops,
                                  tf32x2_flops=kv_flops)
        assert ms == pytest.approx((3 * (flops - kv_flops) + 2 * kv_flops) / 495e12 * 1e3)
        assert 0.0240 < ms < 0.0242
    else:
        ms, by = chip_smoke.bound(nbytes, tf32x3_flops=flops)
        assert ms == pytest.approx(3 * flops / 495e12 * 1e3)
        assert 0.0294 < ms < 0.0296
    assert by == "operations"
    f32_ms, f32_by = chip_smoke.bound(nbytes, flops)
    assert f32_by == "operations" and 0.0725 < f32_ms < 0.0727


def test_kernel_ab_cases_bind_to_this_tree_and_the_parents():
    """kernel_ab calls each tree's chip_smoke check with its positional
    arguments, and passes a keyword only to a tree whose check takes it: the
    positional cases must bind to this tree's checks, and the keyword-only
    arguments K2's cases add (variant, vs_tiled) must not change how the
    positional ones bind, so that an older tree runs the same cases."""
    import inspect

    from bist_tpu_torch.tools import kernel_ab

    for kernel, case, fn, args, kw in kernel_ab.CASES:
        sig = inspect.signature(getattr(chip_smoke, fn))
        sig.bind(None, *args, **kw)
        for name in kw:
            assert sig.parameters[name].kind is inspect.Parameter.KEYWORD_ONLY
    cases = {(k, c): kw for k, c, _, _, kw in kernel_ab.CASES}
    assert cases[("hop1_bwd", "t2s")] == {"variant": "whole", "vs_tiled": True}
    # K3 at every head-dim class: mha's 64, one query row at 16, 320 (the
    # column split)
    flash = {args[4]: kw for k, _, _, args, kw in kernel_ab.CASES if k == "flash_fwd"}
    assert flash == {64: {}, 320: {}, 16: {}}


def test_flash_sweep_crossover_is_the_shortest_kv_from_which_flash_wins():
    """tools/flash_sweep.py's reading: the shortest kv length from which the
    flash branch beats the plain one there and at every longer length
    measured, None when it does not win at the longest."""
    from bist_tpu_torch.tools import flash_sweep

    row = lambda d, Lk, k3, plain: {"d": d, "Lk": Lk, "k3_path_ms": k3, "plain_ms": plain}
    rows = [row(64, 256, 2.0, 1.0), row(64, 1024, 0.9, 1.0), row(64, 4096, 1.1, 1.0),
            row(64, 16384, 0.5, 1.0), row(64, 32768, 0.4, 1.0),
            row(16, 256, 0.5, 1.0), row(16, 1024, 0.5, 1.0), row(16, 32768, 2.0, 1.0)]
    assert flash_sweep.crossover(rows, 64) == 16384
    assert flash_sweep.crossover(rows, 16) is None
    assert flash_sweep.crossover([row(8, 256, 0.1, 1.0)], 8) == 256


def test_flash_probe_bits_have_hooks_in_the_kernel_source():
    """tools/flash_probe.py builds csrc/flash_fwd.cu with FLASH_PROBE set:
    every bit it sets must be read by a hook in the source, which the
    port's build leaves at 0."""
    from bist_tpu_torch.ops import _build
    from bist_tpu_torch.tools import flash_probe

    src = (_build.SRC_DIR / "flash_fwd.cu").read_text()
    assert "#ifndef FLASH_PROBE\n#define FLASH_PROBE 0\n#endif" in src
    assert not any("FLASH_PROBE" in f for f in _build.NVCC_FLAGS)
    assert flash_probe.VARIANTS["kernel"] == 0
    bits = {b for v in flash_probe.VARIANTS.values() for b in (1, 2, 4, 8) if v & b}
    assert bits == {1, 2, 4, 8}
    for b in bits:
        assert f"FLASH_PROBE & {b}" in src, b


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


def test_hop1_probe_marks_every_phase_of_the_whole_bwd_kernel():
    """The same for K2's whole pass 1 (csrc/hop1_bwd.cu): HOP1_BWD_MARK(0)
    .. HOP1_BWD_MARK(7) once each, in order, inside hop1_bwd_whole_kernel,
    empty unless the probe's source defines them before the include."""
    import re

    from bist_tpu_torch.ops import _build
    from bist_tpu_torch.tools import hop1_probe

    src = (_build.SRC_DIR / "hop1_bwd.cu").read_text()
    marks = [(int(m.group(1)), m.start())
             for m in re.finditer(r"HOP1_BWD_MARK\((\d)\);", src)]
    assert [k for k, _ in marks] == list(range(len(hop1_probe.BWD_PHASES) + 1))
    start = src.index("hop1_bwd_whole_kernel(const float*")
    end = src.index("// Issue one stage of the whole dW pass")
    assert all(start < at < end for _, at in marks)
    assert "#ifndef HOP1_BWD_MARK\n#define HOP1_BWD_MARK(k)\n#endif" in src
    probe = hop1_probe.INSTRUMENTED_BWD
    assert probe.index("#define HOP1_BWD_MARK(k)") < probe.index('#include "hop1_bwd.cu"')


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


def test_kernel_ab_long_step_binds_to_chip_smokes_helpers():
    """kernel_ab's phase 18 and phase 17 d_model 1024 train steps
    (`step_speed`, run inside each tree) call chip_smoke's helpers with these
    arguments: they must bind to this tree's, and the constants it reads
    must be there."""
    import inspect

    from bist_tpu_torch.tools import kernel_ab

    assert ("step_speed(dev, int(sys.argv[2]), chip_smoke.REFERENCE_WIDTH,"
            in kernel_ab.CHILD and kernel_ab.LONG_STEPS >= 3)
    assert ("step_speed(dev, int(sys.argv[3]), chip_smoke.WIDTH_1024,"
            in kernel_ab.CHILD and kernel_ab.WIDTH_STEPS >= 3)
    for clips, seed in ((chip_smoke.LONG_CLIPS, 3), ((8, chip_smoke.T_MAX), 1)):
        inspect.signature(chip_smoke.make_batches).bind(None, 1, 32, seed=seed, answers=True,
                                                        clips=clips)
    for width in (chip_smoke.REFERENCE_WIDTH, chip_smoke.WIDTH_1024):
        inspect.signature(chip_smoke.flagship_cfg).bind(1, **width, dropout=0.0,
                                                        attn_dropout=0.0)
    inspect.signature(chip_smoke.copy_state).bind(None)
    inspect.signature(chip_smoke.step_breakdown).bind(None, 2)
    assert chip_smoke.REFERENCE_WIDTH == dict(d_model=512, att_h=8)
    assert chip_smoke.WIDTH_1024 == dict(d_model=1024, att_h=8)
