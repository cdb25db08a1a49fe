"""3D-CNN backbone zoo — ResNet, pre-activation ResNet, WideResNet and
DenseNet variants of the video feature extractor — in PyTorch: the port of
`bist_tpu.models.backbones3d`.

Reference: video-classification-3d-cnn-pytorch/models/{resnet,
pre_act_resnet,wide_resnet,densenet}.py (the kenshohara model zoo, exposed
by the extractor CLI's --model_name).  The conventions of
`models.resnext3d`: `bist_tpu`'s parameter tree (DHWIO kernels, BatchNorm
folded into scale/bias) turned once into a `Net` by `resnext3d.prepare`,
inference only, the three output modes.  The architecture travels as a
static `arch` dict beside the params:

    arch, params = init_backbone(gen, "resnet", depth=18)
    feats = backbone_apply(arch, prepare(params, device), clips, mode="feature")

Reference quirks handled as `bist_tpu` handles them: resnet.py's forward
always returns the pre-avgpool grid (every mode is exposed here);
densenet.py's norm5 is a BatchNorm2d on a 5-D tensor (the folded
scale/bias implements the intended math); shortcut 'A' (strided identity +
zero-padded channels, resnet.py:18-28) and 'B' (1×1×1 conv + BN).
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch
import torch.nn.functional as F

from bist_tpu_torch.models.resnext3d import (Net, _bn, _bn_, _bn_identity, _conv3d,
                                             _conv_init, conv_precision, conv_w, finish,
                                             fold_bn, state_dict_arrays, stem_apply)

Params = Dict[str, Any]

RESNET_LAYERS = {
    10: ("basic", (1, 1, 1, 1)), 18: ("basic", (2, 2, 2, 2)),
    34: ("basic", (3, 4, 6, 3)), 50: ("bottleneck", (3, 4, 6, 3)),
    101: ("bottleneck", (3, 4, 23, 3)), 152: ("bottleneck", (3, 8, 36, 3)),
    200: ("bottleneck", (3, 24, 36, 3)),
}
EXPANSION = {"basic": 1, "bottleneck": 4, "wide": 2}
DENSENET_BLOCKS = {121: (6, 12, 24, 16), 169: (6, 12, 32, 32),
                   201: (6, 12, 48, 32), 264: (6, 12, 64, 48)}
BASE_PLANES = (64, 128, 256, 512)
STAGE_STRIDES = (1, 2, 2, 2)


def _resnet_arch(model_name: str, depth: int, shortcut: str, wide_k: int) -> dict:
    if model_name == "wideresnet":
        block, layers = "wide", RESNET_LAYERS[depth][1]
        planes = tuple(p * wide_k for p in BASE_PLANES)
    else:
        block, layers = RESNET_LAYERS[depth]
        planes = BASE_PLANES
    return {"family": "resnet", "block": block, "layers": layers, "planes": planes,
            "preact": model_name == "preact_resnet", "shortcut": shortcut}


# ---------------------------------------------------------------------------
# Init


def init_backbone(gen: torch.Generator, model_name: str, depth: int = 18,
                  shortcut: str = "B", wide_k: int = 2,
                  n_classes: int = 0) -> Tuple[dict, Params]:
    """Random zoo backbone on the CPU, drawn from `gen`: (arch, params).
    Real use loads a torch checkpoint through load_torch_backbone."""
    if model_name == "densenet":
        return _init_densenet(gen, depth, n_classes)
    arch = _resnet_arch(model_name, depth, shortcut, wide_k)
    block, preact = arch["block"], arch["preact"]
    p: Params = {"stem": {"conv": _conv_init(gen, (7, 7, 7, 3, 64)),
                          "bn": _bn_identity(64)}, "stages": []}
    c_in = 64
    exp = EXPANSION[block]
    for n_blocks, pl, stride in zip(arch["layers"], arch["planes"], STAGE_STRIDES):
        stage: List[Params] = []
        c_out = pl * exp
        for b in range(n_blocks):
            s = stride if b == 0 else 1
            if block == "basic":
                blk = {"bn1": _bn_identity(c_in if preact else pl),
                       "conv1": _conv_init(gen, (3, 3, 3, c_in, pl)),
                       "bn2": _bn_identity(pl),
                       "conv2": _conv_init(gen, (3, 3, 3, pl, pl))}
            else:
                blk = {"bn1": _bn_identity(c_in if preact else pl),
                       "conv1": _conv_init(gen, (1, 1, 1, c_in, pl)),
                       "bn2": _bn_identity(pl),
                       "conv2": _conv_init(gen, (3, 3, 3, pl, pl)),
                       # preact norms before conv3 (pl); post-act after (c_out)
                       "bn3": _bn_identity(pl if preact else c_out),
                       "conv3": _conv_init(gen, (1, 1, 1, pl, c_out))}
            if b == 0 and (s != 1 or c_in != c_out) and shortcut == "B":
                blk["down_conv"] = _conv_init(gen, (1, 1, 1, c_in, c_out))
                blk["down_bn"] = _bn_identity(c_out)
            stage.append(blk)
            c_in = c_out
        p["stages"].append(stage)
    arch["out_features"] = c_in
    if n_classes > 0:
        p["fc"] = {"w": _conv_init(gen, (c_in, n_classes)), "b": torch.zeros(n_classes)}
    return arch, p


def _init_densenet(gen, depth, n_classes, growth: int = 32, bn_size: int = 4):
    blocks = DENSENET_BLOCKS[depth]
    arch = {"family": "densenet", "blocks": blocks, "growth": growth, "bn_size": bn_size}
    p: Params = {"stem": {"conv": _conv_init(gen, (7, 7, 7, 3, 64)),
                          "bn": _bn_identity(64)},
                 "blocks": [], "transitions": []}
    c = 64
    for i, n_layers in enumerate(blocks):
        block = []
        for _ in range(n_layers):
            block.append({
                "bn1": _bn_identity(c),
                "conv1": _conv_init(gen, (1, 1, 1, c, bn_size * growth)),
                "bn2": _bn_identity(bn_size * growth),
                "conv2": _conv_init(gen, (3, 3, 3, bn_size * growth, growth)),
            })
            c += growth
        p["blocks"].append(block)
        if i != len(blocks) - 1:
            p["transitions"].append({"bn": _bn_identity(c),
                                     "conv": _conv_init(gen, (1, 1, 1, c, c // 2))})
            c //= 2
    p["final_bn"] = _bn_identity(c)
    arch["out_features"] = c
    if n_classes > 0:
        p["fc"] = {"w": _conv_init(gen, (c, n_classes)), "b": torch.zeros(n_classes)}
    return arch, p


# ---------------------------------------------------------------------------
# Apply


def _shortcut_a(x: torch.Tensor, c_out: int, stride: int) -> torch.Tensor:
    """Strided identity + zero-padded channels (resnet.py:18-28)."""
    if stride != 1:
        x = x[:, :, ::stride, ::stride, ::stride]
    return F.pad(x, (0, 0, 0, 0, 0, 0, 0, c_out - x.shape[1]))


def _residual(p: Params, x: torch.Tensor, stride: int, c_out: int) -> torch.Tensor:
    if "down_conv" in p:
        return _bn_(p["down_bn"], _conv3d(x, p["down_conv"], stride=stride))
    if x.shape[1] != c_out or stride != 1:
        return _shortcut_a(x, c_out, stride)
    return x


def _res_block(arch: dict, p: Params, x: torch.Tensor, stride: int,
               c_out: int) -> torch.Tensor:
    basic = arch["block"] == "basic"
    s1, s2 = (stride, 1) if basic else (1, stride)
    if arch["preact"]:
        out = _conv3d(_bn(p["bn1"], x).relu_(), p["conv1"], stride=s1)
        out = _conv3d(_bn_(p["bn2"], out).relu_(), p["conv2"], stride=s2)
        if not basic:
            out = _conv3d(_bn_(p["bn3"], out).relu_(), p["conv3"])
        return out.add_(_residual(p, x, stride, c_out))   # no final relu (pre_act_resnet.py:57)
    out = _bn_(p["bn1"], _conv3d(x, p["conv1"], stride=s1)).relu_()
    out = _bn_(p["bn2"], _conv3d(out, p["conv2"], stride=s2))
    if not basic:
        out = _bn_(p["bn3"], _conv3d(out.relu_(), p["conv3"]))
    return out.add_(_residual(p, x, stride, c_out)).relu_()


def backbone_apply(arch: dict, net: Net, clips: torch.Tensor,
                   mode: str = "feature") -> torch.Tensor:
    """clips: (N, T, H, W, 3) Kinetics-normalised frames on the net's device
    → 'feature' (N, D) post-avgpool | 'score' (N, classes) |
    'spatio_temporal' (N, S, D) pre-avgpool grid, channels last."""
    if not isinstance(net, Net):
        raise TypeError("backbone_apply reads a Net: convert the parameter tree "
                        "once with resnext3d.prepare(params, device)")
    params = net.params
    with conv_precision():
        x = stem_apply(net, clips)
        if arch["family"] == "densenet":
            for i, block in enumerate(params["blocks"]):
                for lp in block:
                    y = _conv3d(_bn(lp["bn1"], x).relu_(), lp["conv1"])
                    y = _conv3d(_bn_(lp["bn2"], y).relu_(), lp["conv2"])
                    x = torch.cat([x, y], dim=1)
                if i < len(params["transitions"]):
                    tp = params["transitions"][i]
                    x = F.avg_pool3d(_conv3d(_bn_(tp["bn"], x).relu_(), tp["conv"]), 2, 2)
            return finish(_bn_(params["final_bn"], x).relu_(), params, mode)
        exp = EXPANSION[arch["block"]]
        for stage, pl, stride in zip(params["stages"], arch["planes"], STAGE_STRIDES):
            for b, blk in enumerate(stage):
                x = _res_block(arch, blk, x, stride if b == 0 else 1, pl * exp)
        return finish(x, params, mode)


# ---------------------------------------------------------------------------
# Torch checkpoint conversion (reference main.py:33-35 torch.load of the
# kenshohara zoo checkpoints)


def load_torch_backbone(state_dict, model_name: str, depth: int, shortcut: str = "B",
                        wide_k: int = 2) -> Tuple[dict, Params]:
    """A kenshohara-zoo state dict (tensors or arrays) → (arch, folded-BN
    params), float32 on the CPU."""
    sd = state_dict_arrays(state_dict)
    if model_name == "densenet":
        return _load_torch_densenet(sd, depth)
    arch = _resnet_arch(model_name, depth, shortcut, wide_k)
    p: Params = {"stem": {"conv": conv_w(sd, "conv1"), "bn": fold_bn(sd, "bn1")},
                 "stages": []}
    c_out = 64
    for s, (n_blocks, pl) in enumerate(zip(arch["layers"], arch["planes"])):
        stage = []
        c_out = pl * EXPANSION[arch["block"]]
        for b in range(n_blocks):
            pre = f"layer{s + 1}.{b}"
            blk = {"conv1": conv_w(sd, pre + ".conv1"), "bn1": fold_bn(sd, pre + ".bn1"),
                   "conv2": conv_w(sd, pre + ".conv2"), "bn2": fold_bn(sd, pre + ".bn2")}
            if arch["block"] != "basic":
                blk["conv3"] = conv_w(sd, pre + ".conv3")
                blk["bn3"] = fold_bn(sd, pre + ".bn3")
            if f"{pre}.downsample.0.weight" in sd:
                blk["down_conv"] = conv_w(sd, pre + ".downsample.0")
                blk["down_bn"] = fold_bn(sd, pre + ".downsample.1")
            stage.append(blk)
        p["stages"].append(stage)
    arch["out_features"] = c_out
    if "fc.weight" in sd:
        p["fc"] = {"w": torch.as_tensor(sd["fc.weight"].T.copy()),
                   "b": torch.as_tensor(sd["fc.bias"].copy())}
    return arch, p


def _load_torch_densenet(sd, depth):
    blocks = DENSENET_BLOCKS[depth]
    arch = {"family": "densenet", "blocks": blocks, "growth": 32, "bn_size": 4}
    F_ = "features."
    p: Params = {"stem": {"conv": conv_w(sd, F_ + "conv0"), "bn": fold_bn(sd, F_ + "norm0")},
                 "blocks": [], "transitions": []}
    c = 64
    for i, n_layers in enumerate(blocks):
        blk = []
        for j in range(n_layers):
            pre = f"{F_}denseblock{i + 1}.denselayer{j + 1}"
            blk.append({"bn1": fold_bn(sd, pre + ".norm.1"),
                        "conv1": conv_w(sd, pre + ".conv.1"),
                        "bn2": fold_bn(sd, pre + ".norm.2"),
                        "conv2": conv_w(sd, pre + ".conv.2")})
            c += 32
        p["blocks"].append(blk)
        if i != len(blocks) - 1:
            pre = f"{F_}transition{i + 1}"
            p["transitions"].append({"bn": fold_bn(sd, pre + ".norm"),
                                     "conv": conv_w(sd, pre + ".conv")})
            c //= 2
    p["final_bn"] = fold_bn(sd, F_ + "norm5")
    arch["out_features"] = c
    if "classifier.weight" in sd:
        p["fc"] = {"w": torch.as_tensor(sd["classifier.weight"].T.copy()),
                   "b": torch.as_tensor(sd["classifier.bias"].copy())}
    return arch, p
