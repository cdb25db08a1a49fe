"""Shared fixtures of the `test_torch_port_*` tests: one configuration, one
parameter tree and one numpy batch feed both the JAX package and its
PyTorch port, which runs on the CPU here."""

import jax
import numpy as np
import torch

from bist_tpu.config import ModelConfig as JaxModelConfig
from bist_tpu.data.batching import Batch as JaxBatch
from bist_tpu.models.model import init_model as jax_init_model
from bist_tpu.vocab import PAD
from bist_tpu_torch.config import ModelConfig as TorchModelConfig
from bist_tpu_torch.data.batching import Batch as TorchBatch
from bist_tpu_torch.data.batching import to_device
from bist_tpu_torch.weights import params_from_jax

CPU = torch.device("cpu")

# d_model 32, 4 heads, 2 blocks: the tiny size of the port's tests
BASE = dict(vocab_size=50, nb_blocks=2, nb_venc_blocks=2, nb_cenc_blocks=2,
            nb_aenc_blocks=0, d_model=32, att_h=4, dropout=0.1,
            include_caption="summary", separate_caption=True, ft_sizes=(24,),
            enc_st_combine="none", enc_vc_combine="dyn", dec_st_combine="seq")

# the fusion/pointer/audio variants of tests/test_model_forward.py
CFG_VARIANTS = [
    {},
    {"enc_st_combine": "sum"},
    {"enc_st_combine": "dyn"},
    {"enc_st_combine": "early_sum"},
    {"enc_st_combine": "early_dyn"},
    {"enc_vc_combine": "sum"},
    {"enc_vc_combine": "none"},
    {"dec_st_combine": "sum"},
    {"t2s": False},
    {"s2t": False},
    {"nb_venc_blocks": 0, "ft_sizes": ()},
    {"nb_cenc_blocks": 0, "enc_vc_combine": "none"},
    {"ptr_gen": False},
    {"ptr_ft": "query"},
    {"ptr_ft": "query+cap"},
    {"ptr_ft": "his"},
    {"ptr_ft": "query,cap,his"},
    {"include_caption": "summary", "separate_caption": False,
     "nb_cenc_blocks": 0, "enc_vc_combine": "none", "ptr_ft": "query"},
    {"nb_aenc_blocks": 2, "ft_sizes": (24, 12)},
]


def variant_id(kw):
    return ",".join(f"{k}={v}" for k, v in kw.items()) or "default"


def configs(**kw):
    """(JAX ModelConfig, port ModelConfig) from the same fields."""
    fields = dict(BASE, **kw)
    return JaxModelConfig(**fields), TorchModelConfig(**fields)


def np_batch(rng, cfg, B=2, Lq=5, Lh=7, Lc=4, Lt=6, T=3, S=4):
    """A numpy batch with padded tails, a zero (padded) clip, and a caption
    and features where the config reads them."""
    V = cfg.vocab_size

    def toks(L):
        x = rng.integers(4, V, size=(B, L)).astype(np.int32)
        x[:, -1] = PAD
        return x

    fts = audio = None
    if cfg.nb_venc_blocks > 0:
        fts = rng.standard_normal((B, T, S, cfg.ft_sizes[0])).astype(np.float32)
        fts[:, -1] = 0.0
    if cfg.nb_aenc_blocks > 0:
        audio = rng.standard_normal((B, T, cfg.ft_sizes[1])).astype(np.float32)
    return JaxBatch(query=toks(Lq), his=toks(Lh), trg=toks(Lt), trg_y=toks(Lt),
                    cap=toks(Lc) if cfg.include_caption != "none" else None,
                    fts=fts, audio_fts=audio)


def torch_batch(batch):
    return to_device(TorchBatch(*batch), CPU)


def both_params(jcfg, seed=0):
    """The JAX init_model tree and the same values as port parameters."""
    jp = jax_init_model(jax.random.PRNGKey(seed), jcfg)
    return jp, params_from_jax(jax.tree_util.tree_map(np.asarray, jp), CPU)


def to_np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, dtype=np.float32)


def assert_close(got, want, tol, what=""):
    np.testing.assert_allclose(to_np(got), to_np(want), rtol=tol, atol=tol,
                               err_msg=what)


def zoo_state_dict(name, arch, jparams, seed):
    """A kenshohara-format state dict with the shapes of the DHWIO tree
    `jparams`, random from numpy, with BN running stats."""
    rng = np.random.default_rng(seed)
    sd = {}

    def conv(key, w):
        o = w.shape[-1]
        sd[key + ".weight"] = rng.standard_normal(
            (o, w.shape[3]) + w.shape[:3]).astype(np.float32) * 0.1

    def bn(key, p):
        c = p["scale"].shape[0]
        sd[key + ".weight"] = (1 + 0.1 * rng.standard_normal(c)).astype(np.float32)
        sd[key + ".bias"] = (0.1 * rng.standard_normal(c)).astype(np.float32)
        sd[key + ".running_mean"] = (0.1 * rng.standard_normal(c)).astype(np.float32)
        sd[key + ".running_var"] = rng.uniform(0.5, 1.5, c).astype(np.float32)

    if name == "densenet":
        conv("features.conv0", jparams["stem"]["conv"])
        bn("features.norm0", jparams["stem"]["bn"])
        for i, block in enumerate(jparams["blocks"]):
            for j, lp in enumerate(block):
                pre = f"features.denseblock{i + 1}.denselayer{j + 1}"
                bn(pre + ".norm.1", lp["bn1"])
                conv(pre + ".conv.1", lp["conv1"])
                bn(pre + ".norm.2", lp["bn2"])
                conv(pre + ".conv.2", lp["conv2"])
        for i, tp in enumerate(jparams["transitions"]):
            bn(f"features.transition{i + 1}.norm", tp["bn"])
            conv(f"features.transition{i + 1}.conv", tp["conv"])
        bn("features.norm5", jparams["final_bn"])
        head = "classifier"
    else:
        conv("conv1", jparams["stem"]["conv"])
        bn("bn1", jparams["stem"]["bn"])
        for s, stage in enumerate(jparams["stages"]):
            for b, blk in enumerate(stage):
                pre = f"layer{s + 1}.{b}"
                for i in (1, 2, 3):
                    if f"conv{i}" in blk:
                        conv(f"{pre}.conv{i}", blk[f"conv{i}"])
                        bn(f"{pre}.bn{i}", blk[f"bn{i}"])
                if "down_conv" in blk:
                    conv(pre + ".downsample.0", blk["down_conv"])
                    bn(pre + ".downsample.1", blk["down_bn"])
        head = "fc"
    n_out = arch["out_features"]
    sd[head + ".weight"] = rng.standard_normal((7, n_out)).astype(np.float32)
    sd[head + ".bias"] = rng.standard_normal(7).astype(np.float32)
    return {"module." + k: torch.from_numpy(v) for k, v in sd.items()}
