"""The port's extractor CLI (`python -m bist_tpu_torch.cli.extract_features
--device cpu`) and result-video tool (`bist_tpu_torch.cli.
generate_result_video`) on the CPU, against `bist_tpu`'s CLI on the same
checkpoint: .npy stacks of 112 × 112 frames (which both preprocessings pass
unchanged) through resnet-10 from a synthetic kenshohara-format --model
file.  Features agree to 1e-5 of max |f| (float32, two summation orders);
packed and per-video runs of the port are identical.  Also chip_smoke's
phase 12 at a tiny size (ResNeXt-50, 2-clip batches, the flagship decoder
at d_model 32; marked slow)."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import chip_smoke
from bist_tpu.cli import extract_features as jax_cli
from bist_tpu_torch.cli import extract_features as cli
from bist_tpu_torch.cli.generate_result_video import (annotate_frames, main as video_main,
                                                      unit_labels, write_video)
from bist_tpu_torch.models import backbones3d as zoo
from torch_port_common import zoo_state_dict

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F32_TOL = 1e-5
VIDEOS = {"a": 8, "b": 12, "c": 40}          # 1, 2 and 5 clips at stride 8


@pytest.fixture(autouse=True, scope="module")
def two_threads():
    """Two intra-op threads: the suite runs several test processes on the
    CPU at once, and torch's default of a thread a core makes them thrash
    (a 1-second ResNeXt-50 CLI run took 15 s so)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def videos(tmp_path_factory):
    """.npy frame stacks and a resnet-10 (shortcut B, 7 classes) checkpoint."""
    root = tmp_path_factory.mktemp("extract")
    rng = np.random.default_rng(0)
    (root / "videos").mkdir()
    for vid, n in VIDEOS.items():
        np.save(root / "videos" / f"{vid}.npy",
                rng.integers(0, 256, (n, 112, 112, 3), dtype=np.uint8))
    arch, shapes = zoo.init_backbone(torch.Generator().manual_seed(0), "resnet", 10)
    torch.save({"arch": "resnet-10",
                "state_dict": zoo_state_dict("resnet", arch, shapes, seed=1)},
               root / "resnet-10.pth")
    return root


def base_args(root, out, *extra):
    return ["--video_root", str(root / "videos"), "--output", str(root / out),
            "--stride", "8", "--batch_size", "4", "--model_name", "resnet",
            "--model_depth", "10", "--model", str(root / "resnet-10.pth"), *extra]


@pytest.fixture(scope="module")
def packed(videos):
    cli.main(base_args(videos, "packed", "--device", "cpu"))
    return {v: np.load(videos / "packed" / f"{v}.npy") for v in VIDEOS}


def test_packed_equals_per_video(videos, packed):
    cli.main(base_args(videos, "per_video", "--pack", "0", "--device", "cpu"))
    for vid, n in VIDEOS.items():
        pv = np.load(videos / "per_video" / f"{vid}.npy")
        assert pv.shape == (len(range(0, n - 1, 8)), 16, 512)
        np.testing.assert_array_equal(packed[vid], pv)


def test_features_equal_bist_tpu_cli(videos, packed):
    jax_cli.main(base_args(videos, "jax", "--dp", "1"))
    for vid in VIDEOS:
        want = np.load(videos / "jax" / f"{vid}.npy")
        got = packed[vid]
        assert got.shape == want.shape
        assert np.abs(got - want).max() <= F32_TOL * np.abs(want).max()


def test_score_json_and_skip_on_rerun(videos):
    args = base_args(videos, "scores", "--mode", "score", "--device", "cpu")
    cli.main(args)
    for vid, n in VIDEOS.items():
        with open(videos / "scores" / f"{vid}.json") as f:
            blob = json.load(f)
        assert blob["video"] == vid and len(blob["clips"]) == len(range(0, n - 1, 8))
        for k, c in enumerate(blob["clips"]):
            assert len(c["top5"]) == len(c["scores"]) == 5
            assert all(0 <= i < 7 for i in c["top5"]) and c["scores"] == sorted(c["scores"],
                                                                                reverse=True)
            assert c["segment"] == [8 * k + 1, min(8 * k + 16, n)]   # 1-based, loop-padded
    mtimes = {v: os.path.getmtime(videos / "scores" / f"{v}.json") for v in VIDEOS}
    cli.main(args + ["--pack", "0"])
    cli.main(args)
    assert all(os.path.getmtime(videos / "scores" / f"{v}.json") == t
               for v, t in mtimes.items())


def test_dp_above_one_refused(videos):
    # --dp is ported (tests/test_torch_parallel_cli.py); a --dp that does not
    # divide --batch_size is refused with bist_tpu's message
    with pytest.raises(SystemExit, match="--batch_size 4 not divisible by --dp 3"):
        cli.main(base_args(videos, "dp", "--dp", "3", "--device", "cpu"))


def test_cuda_default_raises_without_a_card(videos):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    assert cli.build_parser().parse_args(["--video_root", "v", "--output", "o"]).device == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(base_args(videos, "cuda"))


def test_int8_and_bf16_close_to_float32(tmp_path):
    """ResNeXt-50 on one 8-frame video: --bf16, --int8 (first-batch static
    scales, stages 3-4), dynamic scales, and --int8-stages all — each within
    bist_tpu's CLI bound of float32 (0.08 relative), and 'all' quantizing
    more than '3,4'."""
    rng = np.random.default_rng(1)
    (tmp_path / "v").mkdir()
    np.save(tmp_path / "v" / "a.npy", rng.integers(0, 256, (8, 112, 112, 3), dtype=np.uint8))
    base = ["--video_root", str(tmp_path / "v"), "--stride", "8", "--batch_size", "1",
            "--model_name", "resnext", "--model_depth", "50", "--device", "cpu"]
    runs = {"f32": [], "bf16": ["--bf16", "1"], "int8": ["--int8", "1"],
            "dynamic": ["--int8", "1", "--int8-calib", "dynamic"],
            "all": ["--int8", "1", "--int8-stages", "all"]}
    out = {}
    for name, extra in runs.items():
        cli.main(base + ["--output", str(tmp_path / name)] + extra)
        out[name] = np.load(tmp_path / name / "a.npy")
    f = out["f32"]
    for name in ("bf16", "int8", "dynamic", "all"):
        assert out[name].shape == f.shape and out[name].dtype == np.float32
        rel = np.linalg.norm(out[name] - f) / np.linalg.norm(f)
        assert rel < 0.08, f"{name}: {rel:.4f}"
    assert np.linalg.norm(out["all"] - out["int8"]) > 0
    with pytest.raises(SystemExit, match="1..4"):
        cli.main(base + ["--output", str(tmp_path / "bad"), "--int8", "1",
                         "--int8-stages", "5"])
    with pytest.raises(SystemExit, match="resnext family"):
        cli.main(base + ["--output", str(tmp_path / "bad"), "--int8", "1",
                         "--model_name", "resnet", "--model_depth", "10"])


def test_load_frames_from_npy_needs_no_pil_and_dirs_match_bist_tpu(tmp_path):
    from PIL import Image

    frames = np.random.default_rng(2).integers(0, 256, (3, 20, 24, 3), dtype=np.uint8)
    (tmp_path / "d").mkdir()
    for i, f in enumerate(frames):
        Image.fromarray(f).save(tmp_path / "d" / f"image_{i + 1:05d}.png")
    np.testing.assert_array_equal(cli.load_frames(str(tmp_path / "d")), frames)
    np.testing.assert_array_equal(cli.load_frames(str(tmp_path / "d")),
                                  jax_cli.load_frames(str(tmp_path / "d")))
    np.save(tmp_path / "s.npy", frames)
    code = ("import sys; sys.modules['PIL'] = None\n"
            "from bist_tpu_torch.cli.extract_features import load_frames\n"
            f"print(load_frames({str(tmp_path / 's.npy')!r}).shape)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=HERE, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0 and "(3, 20, 24, 3)" in r.stdout, r.stderr


# ---------------------------------------------------------------------------
# the result-video tool (tests/test_visualizer.py's cases)


def test_unit_labels_grouping():
    clips = [
        {"top5": [3, 1, 0], "scores": [0.5, 0.3, 0.2], "segment": [1, 16]},
        {"top5": [3, 1, 0], "scores": [0.1, 0.8, 0.1], "segment": [5, 20]},
        {"top5": [2, 4, 0], "scores": [0.9, 0.05, 0.05], "segment": [9, 24]},
    ]
    names = [f"class{i}" for i in range(5)]
    assert unit_labels(clips, names, 0) == [("class1", (1, 24))]
    assert unit_labels(clips, names, 2) == [("class1", (1, 20)), ("class2", (9, 24))]


def test_unit_labels_descending_producer_scores():
    clips = [
        {"top5": [7, 2], "scores": [0.5, 0.4], "segment": [1, 16]},
        {"top5": [2, 9], "scores": [0.6, 0.3], "segment": [5, 20]},
    ]
    names = [f"class{i}" for i in range(10)]
    assert unit_labels(clips, names, 0) == [("class2", (1, 20))]


def test_annotate_and_write_gif_and_frames(tmp_path):
    frames = np.random.default_rng(0).integers(0, 255, size=(6, 64, 80, 3)).astype(np.uint8)
    images = annotate_frames(frames, ["jump"] * 4 + [None] * 2)
    assert len(images) == 6
    assert not np.array_equal(np.asarray(images[0]), frames[0])
    assert np.array_equal(np.asarray(images[5]), frames[5])
    out_gif = write_video(images, str(tmp_path / "v.mp4"), fps=5, fmt="gif")
    assert out_gif.endswith(".gif") and os.path.getsize(out_gif) > 0
    out_dir = write_video(images, str(tmp_path / "v.mp4"), fps=5, fmt="frames")
    assert len(os.listdir(out_dir)) == 6


def test_result_video_from_the_port_extractors_scores(videos, tmp_path):
    """The chain on the CPU: the port's score JSON of a video (its frames
    read by the port's load_frames) into an annotated gif."""
    cli.main(base_args(videos, "scores_for_video", "--mode", "score", "--device", "cpu"))
    names = tmp_path / "classes.txt"
    names.write_text("".join(f"k{i}\n" for i in range(7)))
    dst = tmp_path / "out"
    video_main([str(videos / "scores_for_video" / "c.json"), str(videos / "videos"),
                str(dst), str(names), "0", "--output_format", "gif"])
    assert (dst / "c.gif").exists()
    video_main([str(videos / "scores_for_video"), str(videos / "videos"), str(dst / "frames"),
                str(names), "2", "--output_format", "frames"])
    assert sorted(os.listdir(dst / "frames")) == ["a_frames", "b_frames", "c_frames"]
    assert len(os.listdir(dst / "frames" / "c_frames")) == VIDEOS["c"]


# ---------------------------------------------------------------------------
# chip_smoke's phase 12 at a tiny size


@pytest.mark.slow
def test_phase_extractor_on_cpu(tmp_path):
    """chip_smoke's phase 12 end to end on the CPU: ~7 s alone, but ~3 min
    beside the suite's other workers (some 45 ResNeXt-50 clip forwards in
    three precisions), so tier-1 leaves it out."""
    out = chip_smoke.phase_extractor(
        torch.device("cpu"), str(tmp_path / "p12"), depth=50, batch=2, reps=1, n_check=1,
        videos=((20, 112, 112), (24, 120, 160), (9, 112, 112)), stride=8,
        model_kw=dict(d_model=32, att_h=4, nb_blocks=2, nb_venc_blocks=2, nb_cenc_blocks=2))
    assert abs(out["gflop_per_clip"] - 14.90) < 0.01
    assert out["card_vs_cpu"]["max_abs_err_over_max_abs"] == 0.0
    assert set(out["deviation_from_float32"]) == {"bfloat16", "int8"}
    assert set(out["speed"]) == {"float32", "bfloat16", "int8"}
    assert out["cli"] == dict(out["cli"], videos=3, clips=3 + 3 + 1,
                              packed_equals_per_video="identical")
    assert len(out["int8_sums_exact"]) == 14
    assert out["generate"]["turns"] == 3


def test_int8_sums_exact_holds_every_int8_conv_to_float64(monkeypatch):
    """Phase 12's exactness check on ResNeXt-50's int8 stages 3 and 4 at one
    clip: the 14 convolutions of their first two blocks pass, and a grouped
    sum off by one fails it."""
    from bist_tpu_torch.models import resnext3d as rx

    params = rx.init_resnext101(torch.Generator().manual_seed(0), depth=50)
    with torch.inference_mode():
        net = rx.prepare(rx.quantize_resnext_int8(params, stages=(2, 3)), "cpu")
        checked = chip_smoke.int8_sums_exact(net, (1, 16, 112, 112, 3))
        assert [c["conv"] for c in checked[:2]] == [
            "stage 3 block 0 conv1 on (1, 512, 4, 14, 14)",
            "stage 3 block 0 conv2 on (1, 512, 4, 14, 14)"]
        assert len(checked) == 14 and all(c["max_abs_sum"] > 1e5 for c in checked)
        exact = rx._conv3d_int8
        monkeypatch.setattr(rx, "_conv3d_int8",
                            lambda x, w, s=1: exact(x, w, s) + (w.dim() == 5))
        with pytest.raises(AssertionError, match="stage 3 block 0 conv2"):
            chip_smoke.int8_sums_exact(net, (1, 16, 112, 112, 3))


def test_resnext101_conv_count_by_part():
    """19.1 GFLOP a 16 × 112 × 112 clip at depth 101, a third of it the stem."""
    from bist_tpu_torch.models.resnext3d import init_resnext101

    macs = chip_smoke.resnext_conv_macs(init_resnext101(torch.Generator(), depth=101))
    assert 2 * sum(macs.values()) == 19_133_792_256
    assert abs(macs["stem"] / sum(macs.values()) - 0.345) < 0.001


class _Event:
    def __init__(self, name, start, end, stream=7, annotation=False, device="cuda"):
        from torch.autograd import DeviceType

        self._n, self._s, self._e, self._r, self._a = name, start, end, stream, annotation
        self._d = DeviceType.CUDA if device == "cuda" else DeviceType.CPU

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def end_ns(self):
        return self._e

    def duration_ns(self):
        return self._e - self._s

    def device_type(self):
        return self._d

    def is_user_annotation(self):
        return self._a

    def device_resource_id(self):
        return self._r


def test_device_timeline_takes_the_union_of_intervals():
    """chip_smoke's busy time: overlapping kernels count once, annotations
    and host events not at all."""
    from types import SimpleNamespace

    events = [_Event("conv", 0, 4_000_000), _Event("conv", 3_000_000, 5_000_000, stream=9),
              _Event("relu", 8_000_000, 9_000_000), _Event("range", 0, 20_000_000,
                                                           annotation=True),
              _Event("host", 0, 30_000_000, device="cpu")]
    prof = SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: events)))
    t = chip_smoke.device_timeline(prof)
    assert t["busy_ms"] == 6.0 and t["summed_ms"] == 7.0 and t["streams"] == 2
    assert t["top_kernels"][0] == {"name": "conv", "ms": 6.0, "calls": 2}
    events.insert(0, _Event("spin_kernel", 4_500_000, 6_000_000))
    after = chip_smoke.device_timeline(prof, after="spin_kernel")
    assert after["busy_ms"] == 1.0 and after["top_kernels"] == [
        {"name": "relu", "ms": 1.0, "calls": 1}]
    with pytest.raises(AssertionError, match="no marker"):
        chip_smoke.device_timeline(prof, after="marker")
