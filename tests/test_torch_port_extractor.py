"""The port's video feature extractor (`bist_tpu_torch.models.resnext3d`,
`models.backbones3d`) against `bist_tpu`'s on the CPU: the same numpy
clips and the same parameter tree (carried across by
`weights.params_from_jax`) through both.

Tolerances:
  * float32 features: max |Δ| ≤ 1e-5 · max |f| (float32 through up to 121
    convolutions in two summation orders; measured ≤ 2e-6);
  * int8: quantized kernels, BN scales and static activation scales bit for
    bit; features within one bfloat16 step of max |f| (2^-8: the int8 path
    runs bfloat16 activations, rounded in both by the same rules);
  * preprocessing: within one grey level of PIL's resize (the port rounds
    once after a float resize, PIL to uint8 after each of its two passes);
    frames already 112 on their shorter side exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bist_tpu.models import backbones3d as jzoo
from bist_tpu.models import resnext3d as jrx
from bist_tpu_torch.models import backbones3d as zoo
from bist_tpu_torch.models import resnext3d as rx
from bist_tpu_torch.weights import params_from_jax, params_to_jax
from torch_port_common import zoo_state_dict

CPU = torch.device("cpu")
F32_TOL = 1e-5
BF16_STEP = 2.0 ** -8
MODES = ("spatio_temporal", "temporal_only", "features", "score")


@pytest.fixture(autouse=True, scope="module")
def two_threads():
    """Two intra-op threads: the suite runs several test processes on the
    CPU at once, and torch's default of a thread a core makes them thrash
    (a 1-second ResNeXt-50 CLI run took 15 s so)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def close(got, want, tol=F32_TOL, what=""):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= tol, f"{what}: {err:.3e} of max |f|"


def assert_trees_equal(a, b, path=""):
    """Equal structure, dtypes (numpy) and bits."""
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            assert_trees_equal(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (u, v) in enumerate(zip(a, b)):
            assert_trees_equal(u, v, f"{path}/{i}")
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, (path, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=path)


def clip(seed, shape=(1, 16, 32, 32, 3)):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


# ---------------------------------------------------------------------------
# clip pipeline


@pytest.mark.parametrize("n,dur,stride", [
    (0, 16, 4), (1, 16, 4), (5, 16, 4), (16, 16, 4), (40, 16, 4), (20, 8, 4), (301, 16, 8),
])
def test_clip_windows_equal(n, dur, stride):
    assert rx.make_clip_windows(n, dur, stride) == jrx.make_clip_windows(n, dur, stride)


@pytest.mark.parametrize("h,w", [(120, 160), (240, 320), (360, 480), (100, 90), (64, 80),
                                 (80, 64)])
def test_preprocess_within_one_grey_level(h, w):
    """Downscales (the first four) and upscales (the last two) against
    `bist_tpu`'s PIL bilinear resize: never more than one grey level apart,
    most pixels equal."""
    frames = np.random.default_rng(h * w).integers(0, 256, (3, h, w, 3), dtype=np.uint8)
    got, want = rx.preprocess_frames(frames), jrx.preprocess_frames(frames)
    assert got.shape == want.shape == (3, 112, 112, 3)
    diff = np.abs(got - want)
    assert diff.max() <= 1.0 + 1e-4
    assert (diff < 0.5).mean() > 0.5


def test_preprocess_keeps_112_frames_exactly():
    frames = np.random.default_rng(1).integers(0, 256, (4, 112, 112, 3), dtype=np.uint8)
    np.testing.assert_array_equal(rx.preprocess_frames(frames), jrx.preprocess_frames(frames))
    wide = np.random.default_rng(2).integers(0, 256, (2, 112, 150, 3), dtype=np.uint8)
    np.testing.assert_array_equal(rx.preprocess_frames(wide), jrx.preprocess_frames(wide))


# ---------------------------------------------------------------------------
# ResNeXt


@pytest.fixture(scope="module")
def resnext50():
    """bist_tpu's ResNeXt-50 (7 classes, default GROUP_CH) and its outputs in
    every mode on one (1, 16, 32, 32, 3) clip, from one jit compile."""
    params = np_tree(jrx.init_resnext101(jax.random.PRNGKey(0), n_classes=7, depth=50))
    x = clip(0)
    fn = jax.jit(lambda p, c: {m: jrx.resnext101_apply(p, c, mode=m) for m in MODES})
    return params, x, np_tree(fn(params, jnp.asarray(x)))


@pytest.mark.parametrize("mode", MODES)
def test_resnext_modes_match_bist_tpu(resnext50, mode):
    params, x, want = resnext50
    net = rx.prepare(params_from_jax(params, device=CPU), CPU)
    got = rx.resnext101_apply(net, torch.from_numpy(x), mode)
    close(got.numpy(), want[mode], what=mode)


@pytest.mark.parametrize("memory_format", [torch.contiguous_format, torch.channels_last_3d])
def test_resnext_layouts_agree(resnext50, memory_format, monkeypatch):
    params, x, want = resnext50
    monkeypatch.setattr(rx, "MEMORY_FORMAT", memory_format)
    net = rx.prepare(params_from_jax(params, device=CPU), CPU)
    close(rx.resnext101_apply(net, torch.from_numpy(x)).numpy(), want["spatio_temporal"])


@pytest.mark.parametrize("mode", ["spatio_temporal", "feature"])
def test_finish_flattens_the_grid_row_major(mode):
    """The head on an (N, t', h', w', C) grid with h' ≠ w': the spatial grid
    flattened row-major, channels last, as `bist_tpu` flattens it."""
    x = np.random.default_rng(3).standard_normal((2, 3, 2, 3, 8)).astype(np.float32)
    want = np.asarray(jzoo._finish(jnp.asarray(x), {}, mode))
    got = rx.finish(torch.from_numpy(x).permute(0, 4, 1, 2, 3), {}, mode)
    close(got.numpy(), want)


def test_apply_reads_a_prepared_net(resnext50):
    params, x, _ = resnext50
    with pytest.raises(TypeError, match="prepare"):
        rx.resnext101_apply(params_from_jax(params, device=CPU), torch.from_numpy(x))


def test_init_trees_have_bist_tpu_shapes():
    for depth in (50, 101, 152):
        mine = rx.init_resnext101(torch.Generator().manual_seed(0), n_classes=5, depth=depth)
        ref = jax.eval_shape(lambda: jrx.init_resnext101(jax.random.PRNGKey(0), n_classes=5,
                                                         depth=depth))
        assert jax.tree_util.tree_structure(params_to_jax(mine)) == \
            jax.tree_util.tree_structure(ref)
        assert [a.shape for a in jax.tree_util.tree_leaves(params_to_jax(mine))] == \
            [tuple(a.shape) for a in jax.tree_util.tree_leaves(ref)]


def _bottleneck(rng, c_in, planes, c_out, down):
    def t(*shape, scale=0.2):
        return rng.standard_normal(shape).astype(np.float32) * scale

    blk = {"conv1": t(1, 1, 1, c_in, planes),
           "bn1": {"scale": 1 + t(planes, scale=0.1), "bias": t(planes, scale=0.05)},
           "conv2": t(3, 3, 3, planes // rx.CARDINALITY, planes),
           "bn2": {"scale": 1 + t(planes, scale=0.1), "bias": t(planes, scale=0.05)},
           "conv3": t(1, 1, 1, planes, c_out),
           "bn3": {"scale": 1 + t(c_out, scale=0.1), "bias": t(c_out, scale=0.05)}}
    if down:
        blk["down_conv"] = t(1, 1, 1, c_in, c_out)
        blk["down_bn"] = {"scale": 1 + t(c_out, scale=0.1), "bias": t(c_out, scale=0.05)}
    return blk


@pytest.mark.parametrize("stride,down", [(1, False), (2, True)])
def test_block_record_taps_match_bist_tpu(stride, down):
    """One bottleneck (2 channels a group, merged by bist_tpu's GROUP_CH):
    the three record taps (channels last) and the output."""
    rng = np.random.default_rng(5)
    c = 32 if not down else 48
    blk = _bottleneck(rng, c, 64, 32, down)
    x = rng.standard_normal((2, 4, 8, 8, c)).astype(np.float32)
    want_taps, got_taps = {}, {}
    want = np.asarray(jrx._block(jax.tree_util.tree_map(jnp.asarray, blk), jnp.asarray(x),
                                 stride, record=lambda k, v: want_taps.update({k: np.asarray(v)})))
    tree = {"stem": {"conv": np.zeros((1, 1, 1, 3, c), np.float32)}, "stages": [[blk]]}
    net = rx.prepare(params_from_jax(tree, device=CPU), CPU)
    got = rx.block_apply(net.params["stages"][0][0],
                         torch.from_numpy(x).permute(0, 4, 1, 2, 3), stride,
                         record=lambda k, v: got_taps.update({k: v.clone().numpy()}))
    assert set(got_taps) == set(want_taps) == {"in", "mid1", "mid2"}
    for k in want_taps:
        close(got_taps[k], want_taps[k], what=k)
    close(got.permute(0, 2, 3, 4, 1).numpy(), want, what="out")


# ---------------------------------------------------------------------------
# int8 (the tiny nets of tests/test_resnext3d.py)


def _tiny_net(seed, two_stages=False):
    rng = np.random.default_rng(seed)

    def t(*shape, scale=0.2):
        return rng.standard_normal(shape).astype(np.float32) * scale

    stem = {"conv": t(3, 3, 3, 3, 8), "bn": {"scale": np.ones(8, np.float32),
                                             "bias": np.zeros(8, np.float32)}}
    if not two_stages:
        planes = 64
        blk = {"conv1": t(1, 1, 1, 8, planes),
               "bn1": {"scale": np.full(planes, 1.1, np.float32), "bias": t(planes, scale=0.05)},
               "conv2": t(3, 3, 3, planes // rx.CARDINALITY, planes),
               "bn2": {"scale": np.full(planes, 0.9, np.float32), "bias": t(planes, scale=0.05)},
               "conv3": t(1, 1, 1, planes, 8),
               "bn3": {"scale": np.ones(8, np.float32), "bias": t(8, scale=0.05)}}
        stages = [[blk]]
    else:
        def mkblk(cin, planes, cout):
            return {"conv1": t(1, 1, 1, cin, planes),
                    "bn1": {"scale": np.ones(planes, np.float32), "bias": t(planes, scale=0.05)},
                    "conv2": t(3, 3, 3, planes // rx.CARDINALITY, planes),
                    "bn2": {"scale": np.ones(planes, np.float32), "bias": t(planes, scale=0.05)},
                    "conv3": t(1, 1, 1, planes, cout),
                    "bn3": {"scale": np.ones(cout, np.float32), "bias": t(cout, scale=0.05)},
                    "down_conv": t(1, 1, 1, cin, cout),
                    "down_bn": {"scale": np.ones(cout, np.float32),
                                "bias": np.zeros(cout, np.float32)}}
        stages = [[mkblk(8, 32, 16)], [mkblk(16, 64, 32)]]
    x = rng.standard_normal((2 if not two_stages else 1, 4, 16, 16, 3)).astype(np.float32)
    return {"stem": stem, "stages": stages}, x


@pytest.fixture(scope="module")
def int8_tiny():
    """bist_tpu's tiny one-stage net: its float features, calibration
    readings, quantized trees (dynamic and static) and their features."""
    params, x = _tiny_net(7)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    scales = np_tree(jrx.collect_act_scales(jp, jnp.asarray(x)))
    out = {"params": params, "x": x, "scales": scales,
           "float": np.asarray(jrx.resnext101_apply(jp, jnp.asarray(x)))}
    for kind, act in (("dynamic", None), ("static", scales)):
        q = jrx.quantize_resnext_int8(jp, act_scales=act)
        out[kind] = (np_tree(q), np.asarray(jrx.resnext101_apply(q, jnp.asarray(x)), np.float32))
    return out


def test_int8_calibration_readings_match_bist_tpu(int8_tiny):
    net = rx.prepare(params_from_jax(int8_tiny["params"], device=CPU), CPU)
    close(rx.resnext101_apply(net, torch.from_numpy(int8_tiny["x"])).numpy(),
          int8_tiny["float"])
    got = rx.collect_act_scales(net, torch.from_numpy(int8_tiny["x"]))
    for k in ("in", "mid1", "mid2"):
        close(got[0][0][k].numpy(), int8_tiny["scales"][0][0][k], what=k)


@pytest.mark.parametrize("kind", ["dynamic", "static"])
def test_int8_weights_and_scales_bit_equal(int8_tiny, kind):
    """From the same float tree (and, static, the same calibration readings)
    the port's quantized tree is bist_tpu's bit for bit: int8 kernels,
    float32 BN scales with the weight scales folded in, float32 activation
    scales, bfloat16 stem."""
    tp = params_from_jax(int8_tiny["params"], device=CPU)
    act = None if kind == "dynamic" else int8_tiny["scales"]
    mine = rx.quantize_resnext_int8(tp, act_scales=act)
    want, _ = int8_tiny[kind]
    assert mine["stages"][0][0]["conv2"].dtype == torch.int8
    assert mine["stages"][0][0]["bn2"]["scale"].dtype == torch.float32
    assert mine["stem"]["conv"].dtype == torch.bfloat16
    assert_trees_equal(params_to_jax(mine), params_to_jax(params_from_jax(want, device=CPU)))
    # bist_tpu's quantized tree crosses with its int8 and bfloat16 leaves intact
    crossed = params_from_jax(want, device=CPU)
    assert crossed["stages"][0][0]["conv1"].dtype == torch.int8
    assert crossed["stem"]["conv"].dtype == torch.bfloat16
    flat = lambda t: jax.tree_util.tree_leaves(t, is_leaf=torch.is_tensor)  # noqa: E731
    for a, b in zip(flat(crossed), flat(mine)):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("kind", ["dynamic", "static"])
def test_int8_features_match_bist_tpu(int8_tiny, kind):
    q, want = int8_tiny[kind]
    got = rx.resnext101_apply(rx.prepare(params_from_jax(q, device=CPU), CPU),
                              torch.from_numpy(int8_tiny["x"]))
    assert got.dtype == torch.bfloat16
    close(got.float().numpy(), want, tol=BF16_STEP)
    rel = np.linalg.norm(got.float().numpy() - int8_tiny["float"]) / np.linalg.norm(
        int8_tiny["float"])
    assert rel < 0.06, f"int8 relative feature error {rel:.4f}"


def test_int8_stages_honoured():
    """stages=(1,): stage 2 int8, stage 1 float in bfloat16; both packages'
    mixed nets agree."""
    params, x = _tiny_net(13, two_stages=True)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    jq = jrx.quantize_resnext_int8(jp, stages=(1,))
    want = np.asarray(jrx.resnext101_apply(jq, jnp.asarray(x)), np.float32)
    mine = rx.quantize_resnext_int8(params_from_jax(params, device=CPU), stages=(1,))
    assert mine["stages"][0][0]["conv1"].dtype == torch.bfloat16
    assert mine["stages"][1][0]["conv1"].dtype == torch.int8
    assert "act_s" not in mine["stages"][1][0]
    assert_trees_equal(params_to_jax(mine), params_to_jax(params_from_jax(np_tree(jq),
                                                                          device=CPU)))
    got = rx.resnext101_apply(rx.prepare(mine, CPU), torch.from_numpy(x))
    close(got.float().numpy(), want, tol=BF16_STEP)


@pytest.mark.parametrize("c,o,kernel,stride", [(64, 128, 1, 1), (256, 512, 1, 2),
                                               (1024, 2048, 1, 2), (128, 128, 3, 1),
                                               (1024, 1024, 3, 2)])
def test_int8_conv_sums_are_exact(c, o, kernel, stride):
    """`_conv3d_int8` gives the integer sums of an int8 × int8 conv at the
    real stages' widths (1×1×1 through torch._int_mm, grouped 3³ as float32
    integers below 2^24) — against an int64 sum."""
    rng = np.random.default_rng(c + o + kernel)
    xq = torch.tensor(rng.integers(-127, 128, (1, c, 2, 4, 4)), dtype=torch.int8)
    cin = c // rx.CARDINALITY if kernel == 3 else c
    w = torch.tensor(rng.integers(-127, 128, (kernel, kernel, kernel, cin, o)), dtype=torch.int8)
    got = rx._conv3d_int8(xq, rx._prepare_conv(w, CPU), stride)
    want = torch.nn.functional.conv3d(
        xq.double(), w.permute(4, 3, 0, 1, 2).double(), stride=stride, padding=kernel // 2,
        groups=c // cin)
    assert torch.equal(got.double(), want)


# ---------------------------------------------------------------------------
# the backbone zoo


ZOO = [("resnet", 10, "A"), ("resnet", 10, "B"), ("preact_resnet", 10, "B"),
       ("wideresnet", 10, "B"), ("densenet", 121, "B")]


@pytest.mark.parametrize("name,depth,shortcut", ZOO)
def test_zoo_matches_bist_tpu(name, depth, shortcut):
    """Each family from bist_tpu's random init (5 classes), every mode from
    one jit compile, on one (1, 16, 32, 32, 3) clip."""
    arch, jp = jzoo.init_backbone(jax.random.PRNGKey(1), name, depth, shortcut=shortcut,
                                  n_classes=5)
    jp = np_tree(jp)
    x = clip(1)
    modes = ("feature", "score", "spatio_temporal")
    want = np_tree(jax.jit(lambda p, c: {m: jzoo.backbone_apply(arch, p, c, mode=m)
                                         for m in modes})(jp, jnp.asarray(x)))
    net = rx.prepare(params_from_jax(jp, device=CPU), CPU)
    for m in modes:
        close(zoo.backbone_apply(arch, net, torch.from_numpy(x), m).numpy(), want[m],
              what=f"{name}-{depth} {m}")
    mine_arch, mine = zoo.init_backbone(torch.Generator().manual_seed(0), name, depth,
                                        shortcut=shortcut, n_classes=5)
    assert mine_arch == arch
    assert [a.shape for a in jax.tree_util.tree_leaves(params_to_jax(mine))] == \
        [a.shape for a in jax.tree_util.tree_leaves(jp)]


# ---------------------------------------------------------------------------
# checkpoint converters, on synthetic state dicts with the reference's names


def test_convert_torch_resnext_equals_bist_tpu(tmp_path):
    """A ResNeXt-50 state dict (chip_smoke's synthetic kenshohara
    checkpoint): both converters give one tree (depth inferred), and
    load_torch_resnext reads it from a file."""
    from chip_smoke import kenshohara_resnext_state_dict

    sd = kenshohara_resnext_state_dict(50, seed=0, n_classes=7)
    want = np_tree(jrx.convert_torch_resnext(sd))
    assert [len(s) for s in want["stages"]] == list(rx.DEPTH_BLOCKS[50])
    assert_trees_equal(params_to_jax(rx.convert_torch_resnext(sd)), want)
    path = tmp_path / "resnext-50.pth"
    torch.save({"arch": "resnext-50", "state_dict": sd}, path)
    assert_trees_equal(params_to_jax(rx.load_torch_resnext(str(path))), want)
    bad = {k: v for k, v in sd.items() if not k.startswith("module.layer3.5.")}
    with pytest.raises(ValueError, match="block counts"):
        rx.convert_torch_resnext(bad)


@pytest.mark.parametrize("name,depth,shortcut", ZOO)
def test_load_torch_backbone_equals_bist_tpu(name, depth, shortcut):
    # the port's init has bist_tpu's shapes (test_zoo_matches_bist_tpu)
    arch, shapes = zoo.init_backbone(torch.Generator().manual_seed(0), name, depth,
                                     shortcut=shortcut)
    sd = zoo_state_dict(name, arch, shapes, seed=depth)
    want_arch, want = jzoo.load_torch_backbone(sd, name, depth, shortcut=shortcut)
    got_arch, got = zoo.load_torch_backbone(sd, name, depth, shortcut=shortcut)
    assert got_arch == want_arch
    assert_trees_equal(params_to_jax(got), np_tree(want))
