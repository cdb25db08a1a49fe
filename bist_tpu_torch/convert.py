"""Reference-format checkpoints in and out of the port (the port's
counterpart of `bist_tpu.convert`).

The reference saves a whole pickled nn.Module per best epoch
(<model>_best.pth.tar, train.py:161) plus a pickled (vocab, argparse-args)
companion (<model>.conf, train.py:105-107).  This module maps both to the
port's parameters and back:

    params, cfg, vocab = import_reference_checkpoint(
        "exps/mtn_best.pth.tar", "exps/mtn.conf",
        reference_root="/path/to/BiST", device="cuda")

The mapping is a state-dict walk: torch Linear weights transpose to (in,
out); LayerNorm a_2/b_2 → scale/bias; the reference's index-counter
sublayer lists map to the named slots in wiring order (encoder.py:172-199,
decoder.py:20-58).  The walkers are duck-typed: they read attributes by the
reference's names and need nothing else of its classes.  The `set_*`
walkers are their exact inverses and build a reference model that carries
the port's weights (`export_reference_checkpoint`).

    python -m bist_tpu_torch.convert to-native    REF_PREFIX OUT_PREFIX [--reference-root R]
    python -m bist_tpu_torch.convert to-reference OUR_PREFIX OUT_PREFIX  --reference-root R
"""

from __future__ import annotations

import contextlib
import os
import pickle
import sys
import types
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from bist_tpu_torch import resolve_device
from bist_tpu_torch.config import ModelConfig, TrainConfig
from bist_tpu_torch.models.bist import mm_layer_cross_slots
from bist_tpu_torch.weights import tree_map


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy()


def _linear(tl) -> Dict[str, np.ndarray]:
    return {"w": _np(tl.weight).T.copy(), "b": _np(tl.bias).copy()}


def _norm(tn) -> Dict[str, np.ndarray]:
    return {"scale": _np(tn.a_2).copy(), "bias": _np(tn.b_2).copy()}


def _mha(tm) -> Dict[str, Any]:
    return {k: _linear(tl) for k, tl in zip(("wq", "wk", "wv", "wo"), tm.linears)}


def _ffn(tf) -> Dict[str, Any]:
    return {"w1": _linear(tf.w_1), "w2": _linear(tf.w_2)}


def _vid_names(cfg: ModelConfig):
    """(attention, feed-forward, sublayer) slot names of a video layer in
    the reference's wiring order."""
    attn, ff, sub = [], [], []
    for d in ("t2s", "s2t"):
        if getattr(cfg, d):
            attn += [f"{d}_self", f"{d}_hop1", f"{d}_hop2"]
            ff += [f"{d}_ff"]
            sub += [f"{d}_self", f"{d}_hop1", f"{d}_hop2", f"{d}_ff"]
    return attn, ff, sub


def _vid_layer(tv, cfg: ModelConfig) -> Dict[str, Any]:
    attn_names, ff_names, sub_names = _vid_names(cfg)
    p: Dict[str, Any] = {n: {} for n in set(attn_names + ff_names + sub_names)}
    for tm, n in zip(tv.attn, attn_names):
        p[n]["attn"] = _mha(tm)
    for tf, n in zip(tv.ff, ff_names):
        p[n]["ff"] = _ffn(tf)
    for ts, n in zip(tv.sublayer, sub_names):
        p[n]["norm"] = _norm(ts.norm)
    if hasattr(tv, "out_norm"):
        p["out_norm"] = _norm(tv.out_norm)
    if hasattr(tv, "st_combine_W"):
        p["st_combine_W"] = _linear(tv.st_combine_W)
    return p


def _ctx_layer(tc) -> Dict[str, Any]:
    return {
        "self": {"attn": _mha(tc.attn[0]), "norm": _norm(tc.sublayer[0].norm)},
        "cross": {"attn": _mha(tc.attn[1]), "norm": _norm(tc.sublayer[1].norm)},
        "ff": {"ff": _ffn(tc.ff), "norm": _norm(tc.sublayer[2].norm)},
    }


def _mm_names(cfg: ModelConfig) -> List[str]:
    return ["self", "his", "query"] + [s[0] for s in mm_layer_cross_slots(cfg)]


def _mm_layer(tm, cfg: ModelConfig) -> Dict[str, Any]:
    names = _mm_names(cfg)
    p: Dict[str, Any] = {}
    for t, n in zip(tm.attn, names):
        p[n] = {"attn": _mha(t)}
    for ts, n in zip(tm.sublayer, names + ["ff"]):
        p.setdefault(n, {})["norm"] = _norm(ts.norm)
    p["ff"]["ff"] = _ffn(tm.ff)
    return p


def config_from_ref_args(args, vocab_size: int,
                         ft_sizes: Tuple[int, ...]) -> ModelConfig:
    """Reference argparse namespace → ModelConfig (with the reference's
    hasattr-guard defaults for older checkpoints, e.g. decoder.py:27)."""
    g = lambda k, d: getattr(args, k, d)
    return ModelConfig(
        vocab_size=vocab_size,
        nb_blocks=g("nb_blocks", 6),
        nb_venc_blocks=g("nb_venc_blocks", 0),
        nb_cenc_blocks=g("nb_cenc_blocks", 0),
        nb_aenc_blocks=g("nb_aenc_blocks", 0),
        d_model=g("d_model", 512),
        att_h=g("att_h", 8),
        dropout=g("dropout", 0.1),
        ptr_gen=bool(g("ptr_gen", 1)),
        ptr_ft=g("ptr_ft", "query,cap"),
        mask_unk=bool(g("mask_unk", 1)),
        dec_st_combine=g("dec_st_combine", "seq"),
        enc_st_combine=g("enc_st_combine", "none"),
        enc_vc_combine=g("enc_vc_combine", "dyn"),
        auto_encoder=bool(g("auto_encoder", 1)),
        t2s=bool(g("t2s", 1)),
        s2t=bool(g("s2t", 1)),
        include_caption=g("include_caption", "none"),
        separate_caption=bool(g("separate_caption", 1)),
        ft_sizes=ft_sizes)


def params_from_torch_model(model, cfg: ModelConfig, device=None) -> Dict[str, Any]:
    """Walk a reference MTN module → the port's parameters, float32 tensors
    on `device` (default cuda; raises without it)."""
    device = resolve_device(device)
    params: Dict[str, Any] = {
        "embed": {"lut": _np(model.query_embed[0].lut.weight).copy()},
        "text_enc": {"norms": [_norm(model.text_encoder.norm[i]) for i in range(3)]},
    }
    vid_enc: Dict[str, Any] = {}
    if cfg.has_video and getattr(model.vid_encoder, "v_N", 0) > 0:
        vid_enc["W"] = _linear(model.vid_encoder.W)
        vid_enc["in_norm"] = _norm(model.vid_encoder.in_norm)
    if cfg.has_audio and getattr(model.vid_encoder, "a_N", 0) > 0:
        vid_enc["a_W"] = _linear(model.vid_encoder.a_W)
        vid_enc["a_in_norm"] = _norm(model.vid_encoder.a_in_norm)
    params["vid_enc"] = vid_enc

    tdec = model.mutlimodal_decoder
    dec: Dict[str, Any] = {
        "mm_layers": [_mm_layer(l, cfg) for l in tdec.layers],
        "norm": _norm(tdec.norm),
    }
    if cfg.nb_venc_blocks > 0:
        dec["v_layers"] = [_vid_layer(l, cfg) for l in tdec.v_layers]
        for name in ("temporal_out_norm", "spatial_out_norm", "out_norm"):
            if hasattr(tdec, name):
                dec[name] = _norm(getattr(tdec, name))
        if hasattr(tdec, "st_combine_W"):
            dec["st_combine_W"] = _linear(tdec.st_combine_W)
    if cfg.use_cap_layers:
        dec["c_layers"] = [_ctx_layer(l) for l in tdec.c_layers]
        dec["cap_out_norm"] = _norm(tdec.cap_out_norm)
    if cfg.nb_aenc_blocks > 0:
        dec["a_layers"] = [_ctx_layer(l) for l in tdec.a_layers]
        dec["a_out_norm"] = _norm(tdec.a_out_norm)
    if hasattr(tdec, "vc_combine_W") and cfg.use_cap_layers:
        # the reference also builds vc_combine_W for v>0, c==0 dyn configs
        # (decoder.py:91-105), where its output is dead (decoder.py:27); the
        # port's tree leaves that weight out, so round trips stay exact
        dec["vc_combine_W"] = _linear(tdec.vc_combine_W)
    params["decoder"] = dec

    gen: Dict[str, Any] = {}
    if cfg.ptr_gen:
        gen["pointer_attn"] = [_mha(a) for a in model.generator.pointer_attn] \
            if len(cfg.ptr_ft_list) > 1 else [_mha(model.generator.pointer_attn)]
        gen["pointer_gen_W"] = _linear(model.generator.pointer_gen_W)
    params["gen"] = gen
    return tree_map(lambda a: torch.tensor(a, dtype=torch.float32, device=device), params)


def read_reference_conf(conf_path: str):
    """(vocab, train_args) from the reference's pickled .conf."""
    with open(conf_path, "rb") as f:
        return pickle.load(f)


@contextlib.contextmanager
def _tensor_cuda_is_identity():
    """`torch.Tensor.cuda` as the identity inside the block only: the
    reference's modules call .cuda() as they are rebuilt, and the port's own
    CUDA work in the same process must keep the real method."""
    original = torch.Tensor.cuda
    torch.Tensor.cuda = lambda self, *a, **k: self
    try:
        yield
    finally:
        torch.Tensor.cuda = original


@contextlib.contextmanager
def _on_path(root: Optional[str]):
    if root:
        sys.path.insert(0, root)
    try:
        yield
    finally:
        if root:
            sys.path.remove(root)


def import_reference_checkpoint(pth_path: str, conf_path: str,
                                reference_root: Optional[str] = None,
                                conf_data=None, device=None):
    """(params, ModelConfig, vocab) from a reference .pth.tar + .conf, the
    parameters on `device` (default cuda).

    `reference_root` points at a checkout of the reference so that the
    pickled module classes resolve (torch.save stored the whole module).
    `conf_data` lets a caller that already unpickled the .conf pass the
    (vocab, train_args) tuple."""
    device = resolve_device(device)
    if reference_root and not os.path.isdir(reference_root):
        raise FileNotFoundError(f"--reference-root {reference_root}: no such directory "
                                f"(a checkout of the reference, for its pickled classes)")
    vocab, train_args = (conf_data if conf_data is not None
                         else read_reference_conf(conf_path))
    with _tensor_cuda_is_identity(), _on_path(reference_root):
        model = torch.load(pth_path, map_location="cpu", weights_only=False)
    model = getattr(model, "module", model)   # unwrap DataParallel
    model.eval()

    ft_sizes = []
    if getattr(model.vid_encoder, "v_N", 0) > 0 and model.vid_encoder.W is not None:
        ft_sizes.append(model.vid_encoder.W.in_features)
    if getattr(model.vid_encoder, "a_N", 0) > 0 and \
            getattr(model.vid_encoder, "a_W", None) is not None:
        ft_sizes.append(model.vid_encoder.a_W.in_features)
    cfg = config_from_ref_args(train_args, len(vocab), tuple(ft_sizes))
    return params_from_torch_model(model, cfg, device), cfg, vocab


# ---------------------------------------------------------------------------
# Export: the port's parameters → a checkpoint the reference loads and runs
# (its generate.py:89-93 torch.loads the whole module).  The walkers below
# are the exact inverses of the extractors above.


def _t(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu()
    return torch.from_numpy(np.asarray(x))


def set_linear(tl, p) -> None:
    with torch.no_grad():
        tl.weight.copy_(_t(p["w"]).T)
        tl.bias.copy_(_t(p["b"]))


def set_norm(tn, p) -> None:
    with torch.no_grad():
        tn.a_2.copy_(_t(p["scale"]))
        tn.b_2.copy_(_t(p["bias"]))


def set_mha(tm, p) -> None:
    for tl, key in zip(tm.linears, ("wq", "wk", "wv", "wo")):
        set_linear(tl, p[key])


def set_ffn(tf, p) -> None:
    set_linear(tf.w_1, p["w1"])
    set_linear(tf.w_2, p["w2"])


def set_vid_layer(tv, p, cfg: ModelConfig) -> None:
    attn_names, ff_names, sub_names = _vid_names(cfg)
    for tm, n in zip(tv.attn, attn_names):
        set_mha(tm, p[n]["attn"])
    for tf, n in zip(tv.ff, ff_names):
        set_ffn(tf, p[n]["ff"])
    for ts, n in zip(tv.sublayer, sub_names):
        set_norm(ts.norm, p[n]["norm"])
    if cfg.enc_st_combine in ("early_sum", "early_dyn") and cfg.both_directions:
        set_norm(tv.out_norm, p["out_norm"])
        if cfg.enc_st_combine == "early_dyn":
            set_linear(tv.st_combine_W, p["st_combine_W"])


def set_ctx_layer(tc, p) -> None:
    set_mha(tc.attn[0], p["self"]["attn"])
    set_mha(tc.attn[1], p["cross"]["attn"])
    set_ffn(tc.ff, p["ff"]["ff"])
    for ts, n in zip(tc.sublayer, ("self", "cross", "ff")):
        set_norm(ts.norm, p[n]["norm"])


def set_mm_layer(tm, p, cfg: ModelConfig) -> None:
    names = _mm_names(cfg)
    for t, n in zip(tm.attn, names):
        set_mha(t, p[n]["attn"])
    set_ffn(tm.ff, p["ff"]["ff"])
    for ts, n in zip(tm.sublayer, names + ["ff"]):
        set_norm(ts.norm, p[n]["norm"])


def ref_args_from_config(cfg: ModelConfig, **data_flags):
    """ModelConfig → the argparse namespace the reference pickles into
    `.conf` (the inverse of config_from_ref_args).  `data_flags` overrides
    the data-side fields the reference's generate.py reads from train_args
    (generate.py:100-109): fea_type, skip, max_history_length, merge_source."""
    a = types.SimpleNamespace(
        nb_blocks=cfg.nb_blocks, nb_venc_blocks=cfg.nb_venc_blocks,
        nb_cenc_blocks=cfg.nb_cenc_blocks, nb_aenc_blocks=cfg.nb_aenc_blocks,
        d_model=cfg.d_model, att_h=cfg.att_h, dropout=cfg.dropout,
        ptr_gen=int(cfg.ptr_gen), ptr_ft=cfg.ptr_ft, mask_unk=int(cfg.mask_unk),
        dec_st_combine=cfg.dec_st_combine, enc_st_combine=cfg.enc_st_combine,
        enc_vc_combine=cfg.enc_vc_combine, auto_encoder=int(cfg.auto_encoder),
        t2s=1 if cfg.t2s else 0, s2t=1 if cfg.s2t else 0,
        include_caption=cfg.include_caption, separate_caption=int(cfg.separate_caption),
        # encoder.py:84 reads the undefined args.noW_venc on the audio path;
        # False is the only value under which the reference runs there
        noW_venc=False,
        fea_type=(["resnext_st"] if cfg.has_video else [])
        + (["vggish"] if cfg.has_audio else []),
        skip=1, max_history_length=-1, merge_source=0)
    for k, v in data_flags.items():
        setattr(a, k, v)
    return a


def build_reference_model(params, cfg: ModelConfig,
                          reference_root: Optional[str] = None,
                          ref_mtn=None, args=None):
    """The reference MTN module carrying the port's parameters (equal
    weights, equal forwards).  Pass `ref_mtn` (the reference's model.mtn
    module, or anything with its `make_model`) or `reference_root`."""
    if ref_mtn is None:
        if reference_root is None:
            raise ValueError("need reference_root or ref_mtn")
        with _on_path(reference_root):
            import model.mtn as ref_mtn  # type: ignore[no-redef]
    if args is None:
        args = ref_args_from_config(cfg)
    model = ref_mtn.make_model(cfg.vocab_size, cfg.vocab_size, args,
                               ft_sizes=list(cfg.ft_sizes))
    model.eval()
    with torch.no_grad():
        model.query_embed[0].lut.weight.copy_(_t(params["embed"]["lut"]))
    # text encoder norms (the index advances over present inputs)
    for i, n in enumerate(params["text_enc"]["norms"]):
        set_norm(model.text_encoder.norm[i], n)
    if cfg.has_video:
        set_linear(model.vid_encoder.W, params["vid_enc"]["W"])
        set_norm(model.vid_encoder.in_norm, params["vid_enc"]["in_norm"])
    if cfg.has_audio:
        set_linear(model.vid_encoder.a_W, params["vid_enc"]["a_W"])
        set_norm(model.vid_encoder.a_in_norm, params["vid_enc"]["a_in_norm"])
    dec = params["decoder"]
    tdec = model.mutlimodal_decoder
    for n in range(cfg.nb_blocks):
        set_mm_layer(tdec.layers[n], dec["mm_layers"][n], cfg)
        if cfg.nb_venc_blocks > 0:
            set_vid_layer(tdec.v_layers[n], dec["v_layers"][n], cfg)
        if cfg.use_cap_layers:
            set_ctx_layer(tdec.c_layers[n], dec["c_layers"][n])
        if cfg.nb_aenc_blocks > 0:
            set_ctx_layer(tdec.a_layers[n], dec["a_layers"][n])
    set_norm(tdec.norm, dec["norm"])
    if cfg.nb_venc_blocks > 0 and (cfg.enc_st_combine == "none"
                                   or not cfg.both_directions):
        if cfg.s2t:
            set_norm(tdec.temporal_out_norm, dec["temporal_out_norm"])
        if cfg.t2s:
            set_norm(tdec.spatial_out_norm, dec["spatial_out_norm"])
    elif cfg.nb_venc_blocks > 0 and cfg.enc_st_combine in ("sum", "dyn"):
        # decoder-level st fusion (reference decoder.py:75-80)
        set_norm(tdec.out_norm, dec["out_norm"])
        if cfg.enc_st_combine == "dyn":
            set_linear(tdec.st_combine_W, dec["st_combine_W"])
    if cfg.use_cap_layers:
        set_norm(tdec.cap_out_norm, dec["cap_out_norm"])
    if cfg.nb_aenc_blocks > 0:
        set_norm(tdec.a_out_norm, dec["a_out_norm"])
    if cfg.nb_venc_blocks > 0 and cfg.use_cap_layers and cfg.enc_vc_combine == "dyn":
        set_linear(tdec.vc_combine_W, dec["vc_combine_W"])
    if cfg.ptr_gen and len(cfg.ptr_ft_list) > 1:
        for i in range(len(cfg.ptr_ft_list)):
            set_mha(model.generator.pointer_attn[i], params["gen"]["pointer_attn"][i])
        set_linear(model.generator.pointer_gen_W, params["gen"]["pointer_gen_W"])
    elif cfg.ptr_gen:
        set_mha(model.generator.pointer_attn, params["gen"]["pointer_attn"][0])
        set_linear(model.generator.pointer_gen_W, params["gen"]["pointer_gen_W"])
    return model


def export_reference_checkpoint(params, cfg: ModelConfig, vocab, out_prefix: str,
                                reference_root: Optional[str] = None, ref_mtn=None,
                                **data_flags) -> Tuple[str, str]:
    """Write `<out_prefix>_best.pth.tar` + `<out_prefix>.conf`, which the
    reference loads directly (generate.py:89-93).  Returns (pth_path,
    conf_path).  The pickled module refers to the reference's own classes,
    so loading it needs the reference on sys.path, the reference's own
    deployment contract."""
    args = ref_args_from_config(cfg, **data_flags)
    model = build_reference_model(params, cfg, reference_root=reference_root,
                                  ref_mtn=ref_mtn, args=args)
    pth, conf = out_prefix + "_best.pth.tar", out_prefix + ".conf"
    torch.save(model, pth)
    with open(conf, "wb") as f:
        pickle.dump((vocab, args), f, -1)
    return pth, conf


def is_reference_conf(conf_path: str) -> bool:
    """True if `conf_path` is the reference's pickled (vocab, args) .conf
    (pickle protocol-2 magic b'\\x80'); the port's, like bist_tpu's, is JSON."""
    with open(conf_path, "rb") as f:
        return f.read(1) == b"\x80"


def load_reference_checkpoint_cli(model: str, conf_path: str,
                                  reference_root: Optional[str] = None, device=None):
    """The CLIs' loader of reference-format checkpoints: resolves the
    .pth.tar from a --model value (the file, <expdir>/mtn_best, or the bare
    prefix) and returns (params on `device`, cfg, tcfg, vocab, extra), the
    tuple of the port's own conf + checkpoint path."""
    cand = ([model] if model.endswith(".pth.tar")
            else [model + ".pth.tar", model + "_best.pth.tar"])
    pth = next((c for c in cand if os.path.exists(c)), cand[0])
    conf_data = read_reference_conf(conf_path)
    params, cfg, vocab = import_reference_checkpoint(
        pth, conf_path, reference_root=reference_root, conf_data=conf_data, device=device)
    train_args = conf_data[1]
    tcfg = TrainConfig(
        max_history_length=getattr(train_args, "max_history_length", -1),
        merge_source=bool(getattr(train_args, "merge_source", 0)),
        skip=getattr(train_args, "skip", 1))
    extra = {"fea_type": getattr(train_args, "fea_type", None)}
    return params, cfg, tcfg, vocab, extra


def default_conf_for(model: str) -> str:
    """The .conf of a --model value in either format: strips the checkpoint
    suffixes (<prefix>_best.pth.tar, <prefix>_best, .pth.tar, and the port's
    .pt) so that every form resolves to <prefix>.conf."""
    base = model
    for suf in (".pth.tar", ".pt", "_best"):
        if base.endswith(suf):
            base = base[: -len(suf)]
    return base + ".conf"


def _main(argv=None):
    """Convert checkpoints between the reference's format and the port's.

    to-native: a reference pair (<prefix>_best.pth.tar + pickled .conf) →
    the port's training checkpoint <out>_best.pt (fresh optimizer state, so
    the train CLI's --resume takes it) + JSON <out>.conf.
    to-reference: the port's checkpoint (<prefix>_best.pt or <prefix>.pt +
    <prefix>.conf) → a reference pair the reference's generate.py loads."""
    import argparse

    from bist_tpu_torch.config import load_conf, save_conf
    from bist_tpu_torch.train.checkpoint import save_checkpoint
    from bist_tpu_torch.train.loop import TrainState, trainable
    from bist_tpu_torch.train.schedule import make_optimizer
    from bist_tpu_torch.weights import load_params, tree_leaves

    ap = argparse.ArgumentParser(prog="python -m bist_tpu_torch.convert",
                                 description=_main.__doc__)
    ap.add_argument("direction", choices=["to-native", "to-reference"])
    ap.add_argument("src_prefix")
    ap.add_argument("out_prefix")
    ap.add_argument("--reference-root", default="",
                    help="a checkout of the reference (resolves or provides the "
                         "pickled module classes)")
    args = ap.parse_args(argv)
    root = args.reference_root or None
    cpu = torch.device("cpu")
    os.makedirs(os.path.dirname(args.out_prefix) or ".", exist_ok=True)
    if args.direction == "to-native":
        params, cfg, tcfg, vocab, extra = load_reference_checkpoint_cli(
            args.src_prefix, default_conf_for(args.src_prefix), reference_root=root,
            device=cpu)
        save_conf(args.out_prefix + ".conf", vocab, cfg, tcfg, extra)
        params = trainable(params)
        tx = make_optimizer(cfg.d_model, tcfg.warmup_steps, tcfg.noam_factor,
                            tcfg.adam_b1, tcfg.adam_b2, tcfg.adam_eps)
        save_checkpoint(args.out_prefix + "_best",
                        TrainState(params, tx.init(tree_leaves(params)), 0), epoch=-1)
        print(f"wrote {args.out_prefix}_best.pt + {args.out_prefix}.conf")
    else:
        if not root:
            ap.error("to-reference requires --reference-root")
        vocab, cfg, _, extra = load_conf(args.src_prefix + ".conf")
        ckpt = next((c for c in (args.src_prefix + "_best.pt", args.src_prefix + ".pt")
                     if os.path.exists(c)), args.src_prefix + ".pt")
        pth, conf = export_reference_checkpoint(
            load_params(ckpt, cpu), cfg, vocab, args.out_prefix, root,
            **({"fea_type": extra["fea_type"]} if extra.get("fea_type") else {}))
        print(f"wrote {pth} + {conf}")


if __name__ == "__main__":
    _main()
