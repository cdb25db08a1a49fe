"""A stand-in for the reference's `model/mtn.py`: `make_model(src_vocab,
tgt_vocab, args, ft_sizes)` builds an nn.Module tree with the reference's
attribute names and sublayer lists (`query_embed[0].lut`,
`text_encoder.norm[i].a_2/b_2`, `vid_encoder.W/in_norm/v_N`,
`mutlimodal_decoder.layers/v_layers/c_layers/...`,
`generator.pointer_attn/pointer_gen_W`), shaped by the port's parameter
template of the same configuration and filled from `args.seed` (default
0).  It has no forward: the converters read and write weights only.  As
the reference does (its modules call .cuda() as they are rebuilt), a
module calls `torch.Tensor.cuda` when it is unpickled.

The tests copy this file to <root>/model/mtn.py so that a `torch.save`d
model resolves its classes from a reference root, as a real checkpoint
does."""

import torch
from torch import nn


class LayerNorm(nn.Module):
    def __init__(self, d):
        super().__init__()
        self.a_2 = nn.Parameter(torch.ones(d))
        self.b_2 = nn.Parameter(torch.zeros(d))

    def __setstate__(self, state):
        super().__setstate__(state)
        torch.zeros(1).cuda()


class Sublayer(nn.Module):
    def __init__(self, d):
        super().__init__()
        self.norm = LayerNorm(d)


class Attention(nn.Module):
    def __init__(self, d):
        super().__init__()
        self.linears = nn.ModuleList([nn.Linear(d, d) for _ in range(4)])


class FeedForward(nn.Module):
    def __init__(self, d, d_ff):
        super().__init__()
        self.w_1 = nn.Linear(d, d_ff)
        self.w_2 = nn.Linear(d_ff, d)


class Embeddings(nn.Module):
    def __init__(self, vocab, d):
        super().__init__()
        self.lut = nn.Embedding(vocab, d)


class Layer(nn.Module):
    """A reference layer: `attn`, `ff` (one or a list) and `sublayer`."""

    def __init__(self, d, d_ff, n_attn, n_ff, n_sub):
        super().__init__()
        self.attn = nn.ModuleList([Attention(d) for _ in range(n_attn)])
        ffs = [FeedForward(d, d_ff) for _ in range(max(n_ff, 1))]
        self.ff = nn.ModuleList(ffs) if n_ff else ffs[0]
        self.sublayer = nn.ModuleList([Sublayer(d) for _ in range(n_sub)])


class Module(nn.Module):
    pass


class MTN(nn.Module):
    pass


def linear(p):
    """nn.Linear of a port linear's (in, out) weight shape."""
    d_in, d_out = p["w"].shape
    return nn.Linear(d_in, d_out)


def make_model(src_vocab, tgt_vocab, args, ft_sizes=()):
    from bist_tpu_torch.convert import config_from_ref_args
    from bist_tpu_torch.export import param_template

    cfg = config_from_ref_args(args, src_vocab, tuple(ft_sizes))
    t = param_template(cfg)
    d, d_ff = cfg.d_model, cfg.d_ff
    m = MTN()
    m.query_embed = nn.Sequential(Embeddings(src_vocab, d))
    m.text_encoder = Module()
    m.text_encoder.norm = nn.ModuleList([LayerNorm(d) for _ in range(3)])
    m.vid_encoder = Module()
    m.vid_encoder.v_N, m.vid_encoder.a_N = cfg.nb_venc_blocks, cfg.nb_aenc_blocks
    m.vid_encoder.W = None
    if cfg.has_video:
        m.vid_encoder.W = nn.Linear(ft_sizes[0], d)
        m.vid_encoder.in_norm = LayerNorm(d)
    if cfg.has_audio:
        m.vid_encoder.a_W = nn.Linear(ft_sizes[1], d)
        m.vid_encoder.a_in_norm = LayerNorm(d)

    dt = t["decoder"]
    dec = m.mutlimodal_decoder = Module()
    n_mm = len(dt["mm_layers"][0]) - 1
    dec.layers = nn.ModuleList([Layer(d, d_ff, n_mm, 0, n_mm + 1)
                                for _ in range(cfg.nb_blocks)])
    dec.norm = LayerNorm(d)
    if cfg.nb_venc_blocks > 0:
        layers = []
        for vt in dt["v_layers"]:
            parts = [k for k in vt if k[:3] in ("t2s", "s2t")]
            n_ff = sum(k.endswith("_ff") for k in parts)
            layer = Layer(d, d_ff, len(parts) - n_ff, n_ff, len(parts))
            if "out_norm" in vt:
                layer.out_norm = LayerNorm(d)
            if "st_combine_W" in vt:
                layer.st_combine_W = linear(vt["st_combine_W"])
            layers.append(layer)
        dec.v_layers = nn.ModuleList(layers)
        for name in ("temporal_out_norm", "spatial_out_norm", "out_norm"):
            if name in dt:
                setattr(dec, name, LayerNorm(d))
        if "st_combine_W" in dt:
            dec.st_combine_W = linear(dt["st_combine_W"])
        if cfg.enc_vc_combine == "dyn":
            # built for every dynamic fusion, as the reference's decoder.py:91-105
            # does, though dead without caption layers
            dec.vc_combine_W = linear(dt["vc_combine_W"]) if "vc_combine_W" in dt \
                else nn.Linear(d * 3, 2)
    for name, key in (("c_layers", "cap_out_norm"), ("a_layers", "a_out_norm")):
        if name in dt:
            setattr(dec, name, nn.ModuleList([Layer(d, d_ff, 2, 0, 3)
                                              for _ in dt[name]]))
            setattr(dec, key, LayerNorm(d))

    m.generator = Module()
    if cfg.ptr_gen:
        gt = t["gen"]
        attn = [Attention(d) for _ in gt["pointer_attn"]]
        m.generator.pointer_attn = nn.ModuleList(attn) if len(attn) > 1 else attn[0]
        m.generator.pointer_gen_W = linear(gt["pointer_gen_W"])

    gen = torch.Generator().manual_seed(getattr(args, "seed", 0))
    with torch.no_grad():
        for p in m.parameters():
            p.copy_(torch.randn(p.shape, generator=gen))
    return m
