"""Typed configuration for bist_tpu_torch.

A copy of `bist_tpu.config` (the port imports nothing of the JAX package):
the same dataclasses, field names and defaults, and the same `.conf` JSON
format, so a `.conf` written by either package is read by the other.

`GenerateConfig` has `bist_tpu`'s fields and defaults but `scan_unroll`:
the beam loop here is a Python loop over a static-shape step, so there is
nothing to unroll (the CLIs accept `--scan-unroll` and ignore it).
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple


@dataclass(frozen=True)
class ModelConfig:
    """Static model architecture config (reference flags of
    configs/train_configs.py: --nb-blocks, --d-model, --att-h, ...)."""

    vocab_size: int = 0
    nb_blocks: int = 6
    nb_venc_blocks: int = 0
    nb_cenc_blocks: int = 0
    nb_aenc_blocks: int = 0
    d_model: int = 512
    att_h: int = 8
    dropout: float = 0.1
    # attention-probability dropout (the reference keeps MultiHeadedAttention's
    # constructor default p=0.1, modules.py:67; args.dropout covers the rest)
    attn_dropout: float = 0.1
    ptr_gen: bool = True
    ptr_ft: str = "query,cap"
    mask_unk: bool = True
    dec_st_combine: str = "seq"      # 'seq' | 'sum' (parallel-sum)
    enc_st_combine: str = "none"     # 'none' | 'sum' | 'dyn' | 'early_sum' | 'early_dyn'
    enc_vc_combine: str = "dyn"      # 'none' | 'sum' | 'dyn'
    auto_encoder: bool = True
    t2s: bool = True
    s2t: bool = True
    include_caption: str = "none"    # 'none' | 'caption' | 'summary' | 'caption,summary'
    separate_caption: bool = True
    # input feature dims: [visual_dim] or [visual_dim, audio_dim]; empty = text-only
    ft_sizes: Tuple[int, ...] = ()
    dtype: str = "float32"           # activation dtype; params stay float32
    remat: bool = False              # training: recompute each decoder round
    max_pos: int = 5000              # sinusoidal PE table length (modules.py:127)

    def __post_init__(self):
        if self.d_model % self.att_h != 0:
            raise ValueError(f"d_model={self.d_model} not divisible by att_h={self.att_h}")
        # d_ff = 4·d_model unconditionally (reference mtn.py:70)
        for blocks_name in ("nb_venc_blocks", "nb_cenc_blocks", "nb_aenc_blocks"):
            n = getattr(self, blocks_name)
            if n not in (0, self.nb_blocks):
                raise ValueError(
                    f"{blocks_name}={n} must be 0 or equal nb_blocks={self.nb_blocks}")
        if self.nb_cenc_blocks > 0 and not self.has_caption:
            raise ValueError(
                "nb_cenc_blocks>0 requires a separate caption stream "
                "(include_caption != 'none' and separate_caption); set "
                "nb_cenc_blocks=0 for caption-less configs")
        if self.nb_aenc_blocks > 0 and len(self.ft_sizes) < 2:
            raise ValueError(
                "nb_aenc_blocks>0 requires an audio feature size "
                "(ft_sizes[1]); set nb_aenc_blocks=0 for audio-less configs")
        if self.enc_st_combine not in ("none", "sum", "dyn", "early_sum", "early_dyn"):
            raise ValueError(f"bad enc_st_combine={self.enc_st_combine}")
        if self.enc_vc_combine not in ("none", "sum", "dyn"):
            raise ValueError(f"bad enc_vc_combine={self.enc_vc_combine}")
        if self.dec_st_combine not in ("seq", "sum"):
            raise ValueError(f"bad dec_st_combine={self.dec_st_combine}")

    @property
    def d_ff(self) -> int:
        return self.d_model * 4

    @property
    def has_video(self) -> bool:
        return self.nb_venc_blocks > 0 and len(self.ft_sizes) >= 1

    @property
    def has_audio(self) -> bool:
        return self.nb_aenc_blocks > 0 and len(self.ft_sizes) >= 2

    @property
    def has_caption(self) -> bool:
        return self.include_caption != "none" and self.separate_caption

    @property
    def use_cap_layers(self) -> bool:
        return self.nb_cenc_blocks > 0

    @property
    def both_directions(self) -> bool:
        return self.t2s and self.s2t

    @property
    def ptr_ft_list(self) -> Tuple[str, ...]:
        """Pointer source streams, filtered to ones that exist: without a
        separate caption stream 'cap' drops out and 'query+cap' becomes
        'query'."""
        srcs = []
        for s in self.ptr_ft.split(","):
            if not self.has_caption:
                if s == "cap":
                    continue
                if s == "query+cap":
                    s = "query"
            if s not in srcs:
                srcs.append(s)
        return tuple(srcs) or ("query",)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class TrainConfig:
    """Training hyper-parameters.  Generation reads the data-shaping fields
    (max_history_length, merge_source, skip, the buckets) from the `.conf`."""

    num_epochs: int = 15
    rand_seed: int = 1
    batch_size: int = 32
    max_length: int = 256
    max_history_length: int = -1
    report_interval: int = 100
    warmup_steps: int = 4000
    save_all: bool = False
    cutoff: int = 5
    cut_a: bool = True
    merge_source: bool = False
    skip: int = 1
    num_workers: int = 0
    smoothing: float = 0.1
    noam_factor: float = 1.0
    adam_b1: float = 0.9
    adam_b2: float = 0.98
    adam_eps: float = 1e-9
    data_axis: str = "data"
    num_devices: int = 0             # data-parallel devices (ranks): 0 = every
                                     # local device of the run's device type
    grad_checkpoint: bool = False
    len_buckets: Tuple[int, ...] = (16, 32, 64, 128, 256)
    time_buckets: Tuple[int, ...] = (16, 32, 48, 64)


@dataclass(frozen=True)
class GenerateConfig:
    """Decoding config (reference configs/test_configs.py:7-34)."""

    maxlen: int = 12
    beam: int = 3
    penalty: float = 2.0
    nbest: int = 5
    min_len: int = 1
    dec_eos: bool = False
    undisclosed_only: bool = False
    decode_style: str = "beam_search"
    gen_batch_size: int = 32
    cache_dtype: str = "float32"     # storage of all decode memory: the
                                     # self-attn KV cache and the precomputed
                                     # cross-attn K/V and pointer sources
                                     # (float32, bfloat16, float8_e4m3fn,
                                     # float8_e5m2; float8 is read as bfloat16)
    compute_dtype: str = "float32"   # the decode step's activations; scores,
                                     # softmax and the generator stay float32
    encode_dtype: str = ""           # the context precompute's activations
                                     # ('' = the model's own dtype)
    early_exit: bool = False         # stop once no future completion can
                                     # beat the kept n-best (exact bound)
    temperature: float = 1.0         # sampling knobs (decode_style sample)
    top_k: int = 0
    top_p: float = 0.0
    sample_seed: int = 1             # base seed of the per-request streams


# ---------------------------------------------------------------------------
# (de)serialisation of the `.conf` companion file (JSON)


def config_to_dict(cfg) -> Dict[str, Any]:
    return dataclasses.asdict(cfg)


def model_config_from_dict(d: Dict[str, Any]) -> ModelConfig:
    d = dict(d)
    if "ft_sizes" in d and d["ft_sizes"] is not None:
        d["ft_sizes"] = tuple(d["ft_sizes"])
    return ModelConfig(**d)


def train_config_from_dict(d: Dict[str, Any]) -> TrainConfig:
    d = dict(d)
    for k in ("len_buckets", "time_buckets"):
        if k in d and d[k] is not None:
            d[k] = tuple(d[k])
    return TrainConfig(**d)


def save_conf(path: str, vocab: Dict[str, int], model_cfg: ModelConfig,
              train_cfg: TrainConfig, extra: Optional[Dict[str, Any]] = None) -> None:
    """Write the `.conf` file: vocab + model/train configs, the format
    `bist_tpu.config.save_conf` writes."""
    payload = {
        "vocab": vocab,
        "model": config_to_dict(model_cfg),
        "train": config_to_dict(train_cfg),
        "extra": extra or {},
        "format": "bist_tpu.conf.v1",
    }
    with open(path, "w") as f:
        json.dump(payload, f)


def load_conf(path: str):
    with open(path) as f:
        payload = json.load(f)
    vocab = {k: int(v) for k, v in payload["vocab"].items()}
    model_cfg = model_config_from_dict(payload["model"])
    train_cfg = train_config_from_dict(payload["train"])
    return vocab, model_cfg, train_cfg, payload.get("extra", {})


def default_conf_for(model: str) -> str:
    """`.conf` path for a --model value: strips the checkpoint suffixes
    (`.pt`, `_best`) so `exps/mtn`, `exps/mtn_best` and `exps/mtn.pt` all
    resolve to `exps/mtn.conf`."""
    base = model
    for suf in (".pt", "_best"):
        if base.endswith(suf):
            base = base[: -len(suf)]
    return base + ".conf"
