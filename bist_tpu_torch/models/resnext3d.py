"""ResNeXt-3D video feature extractor (the kenshohara Kinetics ResNeXt) in
PyTorch: the port of `bist_tpu.models.resnext3d`.

Architecture (reference video-classification-3d-cnn-pytorch/models/
resnext.py:71-122): conv3d stem 7³ stride (1, 2, 2) → BN/ReLU → maxpool3d 3³
stride 2 → 4 stages of grouped-conv bottlenecks (cardinality 32, expansion
2, block counts [3, 4, 23, 3] at depth 101).  On 16-frame 112×112 clips the
stage-4 output is (4, 4, 2048) a clip; `spatio_temporal` mode returns that
grid as (N, S=16, D=2048), channels last, the layout the data pipeline
reads.

Parameters: `bist_tpu`'s tree as it is — DHWIO conv kernels, BatchNorm
folded into per-channel scale/bias, the same names — so that a JAX tree
crosses by `weights.params_from_jax`.  `prepare(params, device)` turns it
once into the `Net` the apply functions read: every kernel in PyTorch's
(O, I/g, kD, kH, kW) layout on the device, BN vectors shaped to broadcast
over channels.  Activations are (N, C, T, H, W) in `MEMORY_FORMAT` inside
the net; clips come in and features go out channels last, as in
`bist_tpu`.

Convolutions and pools run through PyTorch's (cuDNN's) conv3d and
max_pool3d, as `bist_tpu` runs them through XLA: no Pallas kernel lies on
this path.  float32 convolutions run in full float32 (TF32 off inside
`resnext101_apply` only), so the card's features agree with the CPU's.

int8 (`quantize_resnext_int8`): per-output-channel int8 weights with their
scale folded into the BN multiplier, int8 activations with a dynamic or a
calibrated static per-tensor scale, and the integer sums `bist_tpu` gets
from an int8 × int8 → int32 convolution: the 1×1×1 convs through
`torch._int_mm`, the grouped 3³ convs as a float32 convolution of
int-valued tensors, exact because every partial sum is an integer below
2^24 (at most 27·32 products of at most 127²).

Left out, as exact rewrites of the same numbers for the TPU's matrix unit:
`bist_tpu`'s space-to-depth stem (`STEM_S2D`) and group merging
(`GROUP_CH`).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

Params = Dict[str, Any]

# Reference zoo depths (model.py:54-64, models/resnext.py:169-185): same
# bottleneck and widths, different block counts
DEPTH_BLOCKS = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3), 152: (3, 8, 36, 3)}
BLOCK_COUNTS = DEPTH_BLOCKS[101]
CARDINALITY = 32
PLANES = (128, 256, 512, 1024)     # mid widths per stage (resnext.py:175)
EXPANSION = 2                      # out = planes * 2
STAGE_STRIDES = (1, 2, 2, 2)
BN_EPS = 1e-5

# Kinetics preprocessing (reference classify.py:12-15, mean.py:1-2):
# Scale(112) → CenterCrop(112) → Normalize(mean, std=1) on 0-255 RGB
KINETICS_MEAN = (114.7748, 107.7354, 99.4750)
SAMPLE_SIZE = 112
SAMPLE_DURATION = 16

# Activation layout inside the net and cuDNN's algorithm search, each chosen
# by timing both on one H100 (`python -m bist_tpu_torch.tools.extract_probe`,
# which sets them for each case in a process of its own; PERF.md §6)
MEMORY_FORMAT = torch.channels_last_3d
CUDNN_BENCHMARK = True


# ---------------------------------------------------------------------------
# Param init (random, for tests; real use loads the torch checkpoint)


def _conv_init(gen: torch.Generator, kshape) -> torch.Tensor:
    fan_in = int(np.prod(kshape[:-1]))
    return torch.randn(kshape, generator=gen) * math.sqrt(2.0 / fan_in)


def _bn_identity(c: int) -> Params:
    return {"scale": torch.ones(c), "bias": torch.zeros(c)}


def init_resnext101(gen: torch.Generator, in_ch: int = 3, n_classes: int = 0,
                    depth: int = 101) -> Params:
    """Random ResNeXt-3D params at `depth` ∈ {50, 101, 152} on the CPU, drawn
    from `gen` (a CPU generator); `prepare` moves them."""
    p: Params = {"stem": {"conv": _conv_init(gen, (7, 7, 7, in_ch, 64)),
                          "bn": _bn_identity(64)},
                 "stages": []}
    c_in = 64
    for n_blocks, planes, stride in zip(DEPTH_BLOCKS[depth], PLANES, STAGE_STRIDES):
        stage: List[Params] = []
        c_out = planes * EXPANSION
        for b in range(n_blocks):
            blk: Params = {
                "conv1": _conv_init(gen, (1, 1, 1, c_in, planes)),
                "bn1": _bn_identity(planes),
                "conv2": _conv_init(gen, (3, 3, 3, planes // CARDINALITY, planes)),
                "bn2": _bn_identity(planes),
                "conv3": _conv_init(gen, (1, 1, 1, planes, c_out)),
                "bn3": _bn_identity(c_out),
            }
            if b == 0 and (c_in != c_out or stride != 1):
                blk["down_conv"] = _conv_init(gen, (1, 1, 1, c_in, c_out))
                blk["down_bn"] = _bn_identity(c_out)
            stage.append(blk)
            c_in = c_out
        p["stages"].append(stage)
    if n_classes > 0:
        p["fc"] = {"w": _conv_init(gen, (c_in, n_classes)), "b": torch.zeros(n_classes)}
    return p


# ---------------------------------------------------------------------------
# The tree the apply functions read


@dataclass
class Net:
    """A parameter tree as `prepare` leaves it on its device."""

    params: Params

    @property
    def device(self) -> torch.device:
        return self.params["stem"]["conv"].device


def _is_conv(name: str) -> bool:
    return name.startswith("conv") or name == "down_conv"


def _prepare_conv(w: torch.Tensor, device) -> torch.Tensor:
    """A DHWIO kernel in the layout its convolution reads: (O, I/g, kD, kH,
    kW) in `MEMORY_FORMAT`; an int8 kernel as `_conv3d_int8` reads it — a
    1×1×1 one as the (I, O) matrix of `torch._int_mm`, any other as its
    float32 values (exact integers)."""
    w = w.to(device)
    if w.dtype == torch.int8 and tuple(w.shape[:3]) == (1, 1, 1):
        return _column_major(w[0, 0, 0])
    if w.dtype == torch.int8:
        w = w.float()
    return w.permute(4, 3, 0, 1, 2).contiguous(memory_format=MEMORY_FORMAT)


def _prepare_tree(tree, device, name=""):
    if isinstance(tree, dict):
        if set(tree) == {"scale", "bias"}:           # a folded BatchNorm
            return {k: v.to(device).reshape(-1, 1, 1, 1) for k, v in tree.items()}
        return {k: _prepare_tree(v, device, k) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_prepare_tree(v, device, name) for v in tree]
    if _is_conv(name):
        return _prepare_conv(tree, device)
    return tree.to(device)


def prepare(params: Params, device=None) -> Net:
    """`bist_tpu`'s tree (DHWIO kernels; float32, bfloat16 or int8 leaves as
    `quantize_resnext_int8` leaves them) → the `Net` on `device` (default
    cuda; raises without it).  Done once: the apply functions never convert
    a weight."""
    from bist_tpu_torch import resolve_device

    return Net(_prepare_tree(params, resolve_device(device)))


# ---------------------------------------------------------------------------
# Apply


def _conv3d(x: torch.Tensor, w: torch.Tensor, stride=1) -> torch.Tensor:
    """conv3d with torch's symmetric k//2 padding (checkpoint parity on every
    strided conv); the group count follows from the kernel's input width."""
    return F.conv3d(x, w, stride=stride, padding=tuple(k // 2 for k in w.shape[2:]),
                    groups=x.shape[1] // w.shape[1])


def _bn(p: Params, x: torch.Tensor) -> torch.Tensor:
    """x·scale + bias, a new tensor."""
    return torch.addcmul(p["bias"], x, p["scale"])


def _bn_(p: Params, y: torch.Tensor) -> torch.Tensor:
    """y·scale + bias in place, on a tensor nothing else reads (a conv's
    output)."""
    return y.mul_(p["scale"]).add_(p["bias"])


def _ndhwc(v: torch.Tensor) -> torch.Tensor:
    """A (N, C, T, H, W) activation as `bist_tpu`'s (N, T, H, W, C) view."""
    return v.permute(0, 2, 3, 4, 1)


def stem_apply(net: Net, clips: torch.Tensor) -> torch.Tensor:
    """(N, T, H, W, 3) clips → the stem's pooled (N, 64, T, H/4, W/4)
    activations, in the stem kernel's dtype."""
    p = net.params["stem"]
    x = clips.permute(0, 4, 1, 2, 3).to(dtype=p["conv"].dtype,
                                        memory_format=MEMORY_FORMAT)
    x = _bn_(p["bn"], _conv3d(x, p["conv"], stride=(1, 2, 2))).relu_()
    return F.max_pool3d(x, kernel_size=3, stride=2, padding=1)   # -inf padding


def block_apply(p: Params, x: torch.Tensor, stride: int, record=None) -> torch.Tensor:
    """One bottleneck.  `record`: an optional `(tap_name, tensor) -> None`
    hook fired at the three to-be-quantized conv inputs ('in', 'mid1',
    'mid2', each as an (N, T, H, W, C) view) of the float path — int8
    calibration (`collect_act_scales`) instruments this very forward.  A
    block with int8 kernels runs the int8 path."""
    if p["conv1"].dtype == torch.int8:
        return _qblock(p, x, stride)
    rec = record if record is not None else (lambda k, v: None)
    rec("in", _ndhwc(x))
    out = _bn_(p["bn1"], _conv3d(x, p["conv1"])).relu_()
    rec("mid1", _ndhwc(out))
    out = _bn_(p["bn2"], _conv3d(out, p["conv2"], stride=stride)).relu_()
    rec("mid2", _ndhwc(out))
    out = _bn_(p["bn3"], _conv3d(out, p["conv3"]))
    if "down_conv" in p:
        x = _bn_(p["down_bn"], _conv3d(x, p["down_conv"], stride=stride))
    return out.add_(x).relu_()


def finish(x: torch.Tensor, params: Params, mode: str) -> torch.Tensor:
    """The last stage's (N, C, t, h, w) activations → the mode's output."""
    if mode == "spatio_temporal":
        # average any residual temporal extent (t' = 1 for 16-frame clips),
        # then the spatial grid row-major → (N, h·w, C)
        return x.mean(dim=2).flatten(2).transpose(1, 2).contiguous()
    x = x.mean(dim=(2, 3, 4))
    if mode == "score" and "fc" in params:
        # classification (reference main.py --mode score): class logits a clip
        from bist_tpu_torch.models.layers import linear

        return linear(params["fc"], x)
    return x


def conv_precision():
    """The cuDNN settings of the extractor's calls: TF32 off (float32 convs in
    full float32), the algorithm search `CUDNN_BENCHMARK`; restored on exit."""
    return torch.backends.cudnn.flags(
        enabled=torch.backends.cudnn.enabled, benchmark=CUDNN_BENCHMARK,
        deterministic=torch.backends.cudnn.deterministic, allow_tf32=False)


def resnext101_apply(net: Net, clips: torch.Tensor, mode: str = "spatio_temporal",
                     record=None) -> torch.Tensor:
    """clips: (N, T, H, W, 3) normalised frames (0-255 minus KINETICS_MEAN)
    on the net's device.

    mode:
      'spatio_temporal' → (N, S, D) per-clip grid, S = h'·w' (16 for 112×112
         inputs), D = 2048, channels last;
      'temporal_only'   → (N, D) post-avgpool embeddings;
      'features'        → (N, D), the same;
      'score'           → (N, classes) with an `fc`, else as 'features'.

    record: optional `(stage_idx, block_idx) -> ((tap, tensor) -> None)`
    factory; int8 calibration hooks (see `block_apply`)."""
    if not isinstance(net, Net):
        raise TypeError("resnext101_apply reads a Net: convert the parameter tree "
                        "once with prepare(params, device)")
    with conv_precision():
        x = stem_apply(net, clips)
        for s, stage in enumerate(net.params["stages"]):
            for b, blk in enumerate(stage):
                x = block_apply(blk, x, STAGE_STRIDES[s] if b == 0 else 1,
                                record=record(s, b) if record is not None else None)
        return finish(x, net.params, mode)


# ---------------------------------------------------------------------------
# int8 inference (extract_features --int8, or quantize_resnext_int8).  The
# stem stays float (bfloat16): its 3 input channels carry most of the
# quantization sensitivity (raw-pixel range).


def _quantize(xf: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    return torch.round(xf / s).clamp_(-127, 127).to(torch.int8)


def _quant_act(x: torch.Tensor):
    """Activations → (int8 tensor, float32 per-tensor scale), dynamic: the
    scale is this tensor's abs-max over 127."""
    xf = x.float()
    s = torch.clamp_min(xf.abs().amax() / 127.0, 1e-12)
    return _quantize(xf, s), s


def _column_major(b: torch.Tensor) -> torch.Tensor:
    """A (K, N) matrix stored column-major: the right operand of the int8
    product in cuBLAS's "TN" form."""
    return b.t().contiguous().t()


def _int_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """int8 (M, K) row-major @ int8 (K, N) column-major → int32, exact.
    cuBLAS's int8 product wants more than 16 rows and K, N multiples of 8:
    zero rows and columns add nothing."""
    m, k = a.shape
    n = b.shape[1]
    pm, pk, pn = max(17 - m, 0), -k % 8, -n % 8
    if pm or pk:
        a = F.pad(a, (0, pk, 0, pm))
    if pk or pn:
        b = _column_major(F.pad(b, (0, pn, 0, pk)))
    return torch._int_mm(a.contiguous(), b)[:m, :n]


def _conv3d_int8(xq: torch.Tensor, w: torch.Tensor, stride=1) -> torch.Tensor:
    """The integer sums of an int8 × int8 conv (`bist_tpu`'s int32
    accumulators), as int32 for a 1×1×1 kernel (w: (I, O) int8) or as exact
    float32 integers for a grouped one (w: its float32 values)."""
    if w.dim() == 2:
        xs = xq[:, :, ::stride, ::stride, ::stride]
        n, c, t, h, wd = xs.shape
        y = _int_mm(_ndhwc(xs).reshape(-1, c), w)
        return y.reshape(n, t, h, wd, -1).permute(0, 4, 1, 2, 3)
    return _conv3d(xq.float(), w, stride=stride)


def _bnq(p: Params, y: torch.Tensor, s_x: torch.Tensor) -> torch.Tensor:
    """Integer conv sums → bfloat16: y·(bn_scale·s_w·s_x) + bias (the weight
    scale s_w was folded into p['scale'] at quantize time)."""
    return (y.float() * (p["scale"] * s_x) + p["bias"]).to(torch.bfloat16)


def _qblock(p: Params, x: torch.Tensor, stride: int) -> torch.Tensor:
    acts = p.get("act_s")
    if acts is None:
        qa = lambda v, k: _quant_act(v)  # noqa: E731
    else:                                # calibrated scales: no reduction
        qa = lambda v, k: (_quantize(v.float(), acts[k]), acts[k])  # noqa: E731
    xq, sx = qa(x, "in")
    out = _bnq(p["bn1"], _conv3d_int8(xq, p["conv1"]), sx).relu_()
    oq, so = qa(out, "mid1")
    out = _bnq(p["bn2"], _conv3d_int8(oq, p["conv2"], stride), so).relu_()
    oq, so = qa(out, "mid2")
    out = _bnq(p["bn3"], _conv3d_int8(oq, p["conv3"]), so)
    if "down_conv" in p:
        x = _bnq(p["down_bn"], _conv3d_int8(xq, p["down_conv"], stride), sx)
    return out.add_(x.to(out.dtype)).relu_()


def collect_act_scales(net: Net, clips: torch.Tensor):
    """Calibration forward for static int8 activation scales: the float net's
    abs-max of every to-be-quantized conv input (block input and the two
    post-relu intermediates), as [[{'in', 'mid1', 'mid2'}, ...] per stage]
    of 0-d float32 tensors; pass it to quantize_resnext_int8(act_scales=).
    The `record` hooks of this very forward take the readings."""
    scales = [[{} for _ in stage] for stage in net.params["stages"]]

    def factory(s, b):
        def rec(k, v):
            scales[s][b][k] = v.float().abs().amax()
        return rec

    resnext101_apply(net, clips, mode="temporal_only", record=factory)
    return scales


def quantize_resnext_int8(params: Params, act_scales=None, stages=None) -> Params:
    """`bist_tpu`'s int8 tree from a float one (DHWIO, as `prepare` takes
    it): per-output-channel int8 kernels for every bottleneck conv, each
    scale folded into its BN's float32 scale; the stem, fc and unquantized
    stages in bfloat16.  Bit for bit `bist_tpu`'s weights and scales.

    act_scales: optional calibration readings (`collect_act_scales`); each
    block then carries static activation scales ('act_s': abs-max / 127 as
    float32) and skips the dynamic abs-max reduction.
    stages: optional 0-based stage indices to quantize; None = all four."""
    def q(w, bn):
        w = w.float()
        s = w.abs().amax(dim=(0, 1, 2, 3)) / 127.0
        s = torch.where(s == 0, torch.ones_like(s), s)
        wq = torch.round(w / s).clamp_(-127, 127).to(torch.int8)
        return wq, {"scale": bn["scale"].float() * s, "bias": bn["bias"].float()}

    from bist_tpu_torch.weights import tree_map

    bf16 = lambda t: t.to(torch.bfloat16)  # noqa: E731
    out: Params = tree_map(bf16, {k: v for k, v in params.items() if k != "stages"})
    keep = set(range(len(params["stages"]))) if stages is None else set(stages)
    out["stages"] = []
    for si, stage in enumerate(params["stages"]):
        if si not in keep:
            out["stages"].append(tree_map(bf16, stage))
            continue
        blocks = []
        for bi, blk in enumerate(stage):
            b2: Params = {}
            for cv, bnm in (("conv1", "bn1"), ("conv2", "bn2"), ("conv3", "bn3")):
                b2[cv], b2[bnm] = q(blk[cv], blk[bnm])
            if "down_conv" in blk:
                b2["down_conv"], b2["down_bn"] = q(blk["down_conv"], blk["down_bn"])
            if act_scales is not None:
                rec = act_scales[si][bi]
                b2["act_s"] = {k: torch.tensor(max(float(rec[k]), 1e-12) / 127.0,
                                               dtype=torch.float32, device=blk["conv1"].device)
                               for k in ("in", "mid1", "mid2")}
            blocks.append(b2)
        out["stages"].append(blocks)
    return out


# ---------------------------------------------------------------------------
# Torch checkpoint conversion


def fold_bn(sd, prefix: str) -> Params:
    """A BatchNorm's weight, bias and running stats (numpy) → scale, bias,
    computed in numpy float32 as `bist_tpu` computes them."""
    gamma, beta, mean, var = (np.asarray(sd[f"{prefix}.{k}"])
                              for k in ("weight", "bias", "running_mean", "running_var"))
    scale = gamma / np.sqrt(var + BN_EPS)
    return {"scale": torch.as_tensor(scale), "bias": torch.as_tensor(beta - mean * scale)}


def conv_w(sd, name: str) -> torch.Tensor:
    """A torch (O, I/g, kD, kH, kW) kernel → DHWIO."""
    return torch.as_tensor(np.asarray(sd[name + ".weight"])).permute(2, 3, 4, 1, 0).contiguous()


def state_dict_arrays(sd) -> dict:
    """A state dict (torch tensors or arrays) without DataParallel's
    'module.' prefixes, as numpy arrays."""
    return {k.replace("module.", ""): (v.detach().cpu().numpy() if hasattr(v, "detach")
                                       else np.asarray(v))
            for k, v in sd.items()}


def load_checkpoint_state_dict(path: str) -> dict:
    """The state dict of a kenshohara-zoo checkpoint (reference main.py:33-35
    torch.load), read with torch.load(weights_only=True)."""
    blob = torch.load(path, map_location="cpu", weights_only=True)
    return blob.get("state_dict", blob)


def load_torch_resnext(ckpt_path: str) -> Params:
    """The pretrained Kinetics ResNeXt checkpoint → the folded-BN tree (on
    the CPU; `prepare` moves it)."""
    return convert_torch_resnext(load_checkpoint_state_dict(ckpt_path))


def convert_torch_resnext(sd) -> Params:
    """torch state_dict (resnext 50/101/152, depth inferred from its block
    counts) → folded-BN tree, float32 on the CPU."""
    sd = state_dict_arrays(sd)
    counts = tuple(1 + max(int(k.split(".")[1]) for k in sd if k.startswith(f"layer{s + 1}."))
                   for s in range(4))
    if counts not in DEPTH_BLOCKS.values():
        raise ValueError(f"unrecognised ResNeXt block counts {counts}")
    p: Params = {"stem": {"conv": conv_w(sd, "conv1"), "bn": fold_bn(sd, "bn1")},
                 "stages": []}
    for s, n_blocks in enumerate(counts):
        stage = []
        for b in range(n_blocks):
            pre = f"layer{s + 1}.{b}"
            blk = {"conv1": conv_w(sd, pre + ".conv1"), "bn1": fold_bn(sd, pre + ".bn1"),
                   "conv2": conv_w(sd, pre + ".conv2"), "bn2": fold_bn(sd, pre + ".bn2"),
                   "conv3": conv_w(sd, pre + ".conv3"), "bn3": fold_bn(sd, pre + ".bn3")}
            if f"{pre}.downsample.0.weight" in sd:
                blk["down_conv"] = conv_w(sd, pre + ".downsample.0")
                blk["down_bn"] = fold_bn(sd, pre + ".downsample.1")
            stage.append(blk)
        p["stages"].append(stage)
    if "fc.weight" in sd:
        p["fc"] = {"w": torch.as_tensor(sd["fc.weight"].T.copy()),
                   "b": torch.as_tensor(sd["fc.bias"].copy())}
    return p


# ---------------------------------------------------------------------------
# Clip pipeline (reference dataset.py:82-111, classify.py:12-20,
# temporal_transforms.py:5-17)


def make_clip_windows(n_frames: int, sample_duration: int = SAMPLE_DURATION,
                      stride: int = 4) -> List[List[int]]:
    """Sliding `sample_duration`-frame windows with `stride`; short windows
    loop-padded (0-based frame indices)."""
    if n_frames <= 0:
        return []
    windows = []
    for start in range(0, max(n_frames - 1, 1), stride):
        idx = list(range(start, min(start + sample_duration, n_frames)))
        for i in idx:                     # LoopPadding: repeat from window start
            if len(idx) >= sample_duration:
                break
            idx.append(i)
        windows.append(idx[:sample_duration])
    return windows


def preprocess_frames(frames: np.ndarray, chunk: int = 256) -> np.ndarray:
    """(T, H, W, 3) uint8 RGB → (T, 112, 112, 3) float32: the shorter side
    scaled to 112, centre-cropped to 112², Kinetics means subtracted (std 1).

    The scaling is bilinear with antialiasing (`F.interpolate`, which follows
    PIL's filter support) on float frames, rounded and clamped to 0..255:
    within one grey level of `bist_tpu`'s PIL resize, which rounds to uint8
    between its horizontal and vertical passes.  Frames already 112 on their
    shorter side pass unchanged, as through PIL."""
    t, h, w = frames.shape[:3]
    if w < h:
        ow, oh = SAMPLE_SIZE, int(round(SAMPLE_SIZE * h / w))
    else:
        oh, ow = SAMPLE_SIZE, int(round(SAMPLE_SIZE * w / h))
    top, left = (oh - SAMPLE_SIZE) // 2, (ow - SAMPLE_SIZE) // 2
    out = np.empty((t, SAMPLE_SIZE, SAMPLE_SIZE, 3), np.float32)
    for s in range(0, t, chunk):
        x = torch.from_numpy(np.ascontiguousarray(frames[s:s + chunk])).permute(0, 3, 1, 2).float()
        if (oh, ow) != (h, w):
            x = F.interpolate(x, size=(oh, ow), mode="bilinear", align_corners=False,
                              antialias=True).round_().clamp_(0, 255)
        x = x[:, :, top:top + SAMPLE_SIZE, left:left + SAMPLE_SIZE]
        out[s:s + chunk] = x.permute(0, 2, 3, 1).numpy()
    out -= np.asarray(KINETICS_MEAN, np.float32)
    return out


def clips_of(frames: np.ndarray, sample_duration: int, stride: int):
    """A video's preprocessed clips (n, sample_duration, 112, 112, 3) and
    their frame windows; raises on a video without frames."""
    proc = preprocess_frames(frames)
    windows = make_clip_windows(len(proc), sample_duration, stride=stride)
    if not windows:
        raise ValueError("no frames")
    return np.stack([proc[w] for w in windows]), windows


def batch_apply(net: Net, mode: str, dtype: torch.dtype = torch.float32, apply=None):
    """A function (n, T, H, W, 3) float32 numpy clips → their float32 numpy
    outputs: copied to the net's device, cast to `dtype`, run through
    `apply(net, clips, mode)` (default `resnext101_apply`)."""
    apply = apply or resnext101_apply

    def run(chunk: np.ndarray) -> np.ndarray:
        x = torch.from_numpy(chunk).to(net.device).to(dtype)
        return apply(net, x, mode).float().cpu().numpy()

    return run


def extract_video_features(net: Optional[Net], frames: np.ndarray, stride: int = 4,
                           batch_size: int = 32, mode: str = "spatio_temporal",
                           apply_fn=None,
                           sample_duration: int = SAMPLE_DURATION) -> np.ndarray:
    """frames: (T, H, W, 3) uint8 → (n_clips, S, 2048) features (or
    (n_clips, 2048) for temporal_only).  apply_fn: numpy clips → numpy
    outputs (default `batch_apply(net, mode)`).  Every batch is
    `batch_size` clips, the last zero-padded, so the convolutions see one
    shape."""
    clips, _ = clips_of(frames, sample_duration, stride)
    if apply_fn is None:
        apply_fn = batch_apply(net, mode)
    outs = []
    for s in range(0, len(clips), batch_size):
        chunk = clips[s:s + batch_size]
        real = len(chunk)
        if real < batch_size:
            chunk = np.concatenate(
                [chunk, np.zeros((batch_size - real,) + chunk.shape[1:], np.float32)])
        outs.append(apply_fn(chunk)[:real])
    return np.concatenate(outs, axis=0)
