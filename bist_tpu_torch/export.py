"""Serving bundles: one `torch.export` program per decode geometry, written
beside the weights and the vocabulary (the port's counterpart of
`bist_tpu.export`, whose programs are `jax.export` artifacts).

Bundle layout (a directory):

    bundle.json     format tag, ModelConfig / GenerateConfig dicts, the
                    geometry table {key -> shapes}, torch version, and the
                    device types the programs were exported on
    vocab.json      word -> id
    params.npz      flat parameter arrays keyed by `bist_tpu`'s keystr
                    paths ("['embed']['lut']", ...), so the file is
                    interchangeable with a `bist_tpu` bundle's
    programs/<device type>/<key>.pt2   one `torch.export.save`d program per
                    (device type, geometry)

Parameters stay ARGUMENTS of the programs, not constants: a program holds
no weight (its state dict is empty), and a weight refresh is a params.npz
swap with no re-export.  A program takes the flat parameters in keystr
order, then the Batch's fields that are not None in field order, and
returns beam search's (tokens, scores, lengths) or greedy's (B, maxlen)
ids.  Beam search is exported as one fixed-length search (`early_exit`
needs the host between steps; the bound is exact, so the tokens are the
same).  K1 and K3 are registered ops (`ops.bist_kernels.hop1_fwd_op`,
`ops.flash_attention.flash_fwd_op`), so a program holds them as nodes and
runs their CUDA implementation on the card; tracing runs their fakes and
builds no kernel.

Geometries are exact shapes (batch rows, token lengths, video grid) with
`bist_tpu`'s keys.  `Bundle.beam_fn()` dispatches on a batch's shapes and
raises KeyError for a geometry the bundle does not carry: a bundle host
never traces.  `Bundle.make_responder()` serves through the programs, one
CUDA graph per geometry (`decode.compiled.DecodeProgram`), and
`Responder.warmup_geometries` captures the whole table at startup.

Programs exported on one device type run on it only: `load_bundle` refuses
a device whose type the bundle was not exported on, and never moves a CPU
program onto the card.

Data-parallel bundles (`save_bundle(dp=n)`, `bist_tpu`'s dp): a geometry
keeps `bist_tpu`'s key of the GLOBAL batch (B rows) and its program is
exported at B/n rows, one device's row block; bundle.json records
`"dp": n`.  `Bundle.make_responder` serves it over n devices, each
device's `DecodeProgram` running the programs on its rows
(`serving.Responder`, `beam_fn_devices`), so a dp bundle needs n devices
(or an explicit list of n, which may repeat one).  A program is moved to
another card of its type with `torch.export.passes.move_to_device_pass`
when a device first calls it.
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from bist_tpu_torch import resolve_device
from bist_tpu_torch.config import (GenerateConfig, ModelConfig, config_to_dict,
                                   model_config_from_dict)
from bist_tpu_torch.data.batching import Batch
from bist_tpu_torch.decode import beam
from bist_tpu_torch.models.layers import positional_encoding_table
from bist_tpu_torch.models.model import init_model
from bist_tpu_torch.ops import bist_kernels, flash_attention  # noqa: F401  the ops
from bist_tpu_torch.vocab import PAD, SOS
from bist_tpu_torch.weights import tree_map

FORMAT = "bist_tpu_torch.bundle.v1"
STYLES = ("beam_search", "greedy")


# ---------------------------------------------------------------------------
# params <-> flat npz


def _paths(tree, prefix: str = ""):
    """(keystr path, leaf) pairs in `jax.tree_util`'s order: dict keys
    sorted, list items by index."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in _paths(tree[k], f"{prefix}[{k!r}]")]
    if isinstance(tree, (list, tuple)):
        return [p for i, v in enumerate(tree) for p in _paths(v, f"{prefix}[{i}]")]
    return [(prefix, tree)]


def _rebuild(template, leaves):
    """`template`'s tree with the next leaves of the iterator `leaves`, in
    `_paths`' order."""
    if isinstance(template, dict):
        return {k: _rebuild(template[k], leaves) for k in sorted(template)}
    if isinstance(template, (list, tuple)):
        return [_rebuild(v, leaves) for v in template]
    return next(leaves)


def flatten_params(params) -> Dict[str, np.ndarray]:
    """Parameter tree -> {keystr path: float32 numpy array}, the keys and
    arrays of `bist_tpu.export.flatten_params`."""
    return {k: t.detach().to("cpu", torch.float32).numpy() for k, t in _paths(params)}


def param_template(cfg: ModelConfig):
    """The parameter tree of `cfg` on the meta device: names and shapes,
    no values and no arithmetic (the port's `jax.eval_shape`)."""
    with torch.device("meta"):
        return init_model(0, cfg, device="meta")


def unflatten_params(flat: Dict[str, np.ndarray], cfg: ModelConfig, device=None):
    """Rebuild the parameter tree from keystr-keyed arrays onto `device`
    (default cuda).  The tree comes from `param_template`; a missing key or
    a shape the config does not imply raises, as in `bist_tpu`."""
    device = resolve_device(device)
    template = param_template(cfg)
    leaves = []
    for key, t in _paths(template):
        if key not in flat:
            raise KeyError(f"params.npz is missing {key} (bundle/config mismatch?)")
        arr = np.asarray(flat[key])
        if tuple(arr.shape) != tuple(t.shape):
            raise ValueError(f"param {key}: npz shape {arr.shape} != "
                             f"config-implied {tuple(t.shape)}")
        leaves.append(torch.tensor(arr, dtype=torch.float32, device=device))
    return _rebuild(template, iter(leaves))


# ---------------------------------------------------------------------------
# geometries


def geometry_of(batch: Batch) -> Dict[str, Any]:
    """Shape descriptor of a batch (numpy arrays or tensors)."""
    g: Dict[str, Any] = {
        "B": int(batch.query.shape[0]),
        "Lq": int(batch.query.shape[1]),
        "Lh": int(batch.his.shape[1]),
        "Lt": int(batch.trg.shape[1]),
    }
    if batch.cap is not None:
        g["Lc"] = int(batch.cap.shape[1])
    if batch.fts is not None:
        g["T"], g["S"], g["Dv"] = (int(d) for d in batch.fts.shape[1:4])
        g["int8"] = batch.fts_scale is not None
    if batch.audio_fts is not None:
        g["Ta"], g["Da"] = (int(d) for d in batch.audio_fts.shape[1:3])
    return g


def geometry_key(geom: Dict[str, Any]) -> str:
    return "_".join(f"{k}{int(v)}" for k, v in sorted(geom.items()))


def host_batch(geom: Dict[str, Any], cfg: ModelConfig) -> Batch:
    """A numpy batch of geometry `geom` with the dtypes a Responder
    assembles: <sos> then PAD tokens, zero features (int8 with its float32
    scale where `int8` is set)."""
    from bist_tpu_torch.data.batching import quantize_features

    n = geom["B"]

    def tok(L):
        a = np.full((n, L), PAD, np.int32)
        a[:, 0] = SOS
        return a

    fts = scale = audio = None
    if cfg.has_video:
        fts = np.zeros((n, geom["T"], geom["S"], geom["Dv"]), np.float32)
        if geom.get("int8"):
            fts, scale = quantize_features(fts)
    if cfg.has_audio:
        audio = np.zeros((n, geom["Ta"], geom["Da"]), np.float32)
    trg = np.full((n, geom.get("Lt", 1)), SOS, np.int32)
    return Batch(query=tok(geom["Lq"]), his=tok(geom["Lh"]), trg=trg, trg_y=trg,
                 cap=tok(geom["Lc"]) if cfg.has_caption else None,
                 fts=fts, audio_fts=audio, fts_scale=scale)


def abstract_batch(geom: Dict[str, Any], cfg: ModelConfig, device=None) -> Batch:
    """Example tensors of geometry `geom` on `device` (default cuda) for
    `torch.export`: `host_batch`'s arrays there."""
    device = resolve_device(device)
    return Batch(*[None if x is None else torch.from_numpy(x).to(device)
                   for x in host_batch(geom, cfg)])


def default_serving_geometries(
        cfg: ModelConfig,
        batch_buckets: Sequence[int] = (8, 16, 32, 64),
        Lq=16, Lh=16, Lc=16, Lt: int = 1,
        T=16, S: int = 16, Ta=None,
        feat_int8: bool = False) -> List[Dict[str, Any]]:
    """Geometries covering the serving bucket space: the cross product of
    batch_buckets × Lq × Lh × Lc × T (each an int or a sequence of
    buckets), exactly the shapes `Responder.make_batch` produces with these
    buckets (`Bundle.make_responder` derives them back from the table).  Ta
    (audio frames) defaults to T's buckets, crossed independently with
    them, as serving buckets the two time axes separately; a single int Ta
    pads audio to one length.  The list of `bist_tpu.export`'s function."""

    def seq(v):
        return tuple(v) if isinstance(v, (tuple, list)) else (v,)

    t_buckets = seq(T) if cfg.has_video else (None,)
    ta_buckets = seq(T if Ta is None else Ta) if cfg.has_audio else (None,)
    geoms = []
    for b in batch_buckets:
        for lq in seq(Lq):
            for lh in seq(Lh):
                for lc in (seq(Lc) if cfg.has_caption else (None,)):
                    for t in t_buckets:
                        for ta in ta_buckets:
                            g: Dict[str, Any] = {"B": b, "Lq": lq, "Lh": lh, "Lt": Lt}
                            if cfg.has_caption:
                                g["Lc"] = lc
                            if cfg.has_video:
                                g.update(T=t, S=S, Dv=cfg.ft_sizes[0], int8=feat_int8)
                            if cfg.has_audio:
                                g.update(Ta=ta, Da=cfg.ft_sizes[1])
                            geoms.append(g)
    return geoms


# ---------------------------------------------------------------------------
# save / load


class _Decode(torch.nn.Module):
    """The exported function: (flat parameters..., batch fields...) -> the
    decode's outputs.  It holds the tree's structure and the configs, no
    tensor."""

    def __init__(self, template, fields: Sequence[str], cfg: ModelConfig,
                 gcfg: GenerateConfig):
        super().__init__()
        self.template = tree_map(lambda t: None, template)    # the structure only
        self.fields = tuple(fields)
        self.n_params = len(_paths(template))
        self.cfg, self.gcfg = cfg, gcfg

    def forward(self, *args):
        params = _rebuild(self.template, iter(args[:self.n_params]))
        given = dict(zip(self.fields, args[self.n_params:]))
        batch = Batch(*[given.get(f) for f in Batch._fields])
        g = self.gcfg
        if g.decode_style == "greedy":
            return beam.greedy_decode(params, self.cfg, batch, g.maxlen,
                                      cache_dtype=g.cache_dtype, encode_dtype=g.encode_dtype,
                                      compute_dtype=g.compute_dtype)
        return tuple(beam.beam_search(params, self.cfg, batch, g))


def _check_exportable(gcfg: GenerateConfig, dp: int,
                      geometries: Sequence[Dict[str, Any]]) -> None:
    if gcfg.decode_style not in STYLES:
        raise ValueError(f"bundles support decode_style 'beam_search' or 'greedy', "
                         f"not {gcfg.decode_style!r}")
    if dp < 1:
        raise ValueError(f"dp={dp}: a bundle's rows split over at least one device")
    bad = [g["B"] for g in geometries if g["B"] % dp]
    if bad:
        raise ValueError(f"geometry batch sizes {bad} not divisible by dp={dp}")


def _export_one(path: str, params, cfg: ModelConfig, gcfg: GenerateConfig,
                platform: str, key: str, geom: Dict[str, Any]) -> float:
    """Export and save the program of one (device type, geometry); returns
    its seconds."""
    t0 = time.perf_counter()
    device = resolve_device(platform)
    leaves = [t.to(device) for _, t in _paths(params)]
    # built outside the trace (cached by the parameters' device), so the
    # table is a constant of the program
    positional_encoding_table(cfg.d_model, cfg.max_pos, leaves[0].device)
    batch = abstract_batch(geom, cfg, device)
    fields = [f for f, x in zip(Batch._fields, batch) if x is not None]
    with torch.no_grad():
        ep = torch.export.export(_Decode(param_template(cfg), fields, cfg, gcfg),
                                 tuple(leaves) + tuple(x for x in batch if x is not None),
                                 strict=False)
    # a tensor on another device (a constant, a table built in the trace)
    # would be copied in every call, and no CUDA graph takes a copy from
    # pageable host memory
    stray = [n.name for n in ep.graph.nodes if isinstance(n.meta.get("val"), torch.Tensor)
             and n.meta["val"].device.type != device.type]
    if stray:
        raise RuntimeError(f"exporting {key} on {device}: tensors on another device in "
                           f"the program: {stray[:8]}")
    ep.example_inputs = None       # the example batch and weights stay out of the file
    torch.export.save(ep, os.path.join(path, "programs", platform, key + ".pt2"))
    return time.perf_counter() - t0


def _export_worker(path, flat, cfg, gcfg, platform, key, geom) -> float:
    """`_export_one` in a worker process, from the flat parameters."""
    torch.set_num_threads(1)
    return _export_one(path, unflatten_params(flat, cfg, platform), cfg, gcfg, platform,
                       key, geom)


def save_bundle(path: str, params, cfg: ModelConfig, gcfg: GenerateConfig,
                vocab: Dict[str, int], geometries: Sequence[Dict[str, Any]],
                platforms: Optional[Sequence[str]] = None,
                dp: int = 1, workers: int = 1) -> Dict[str, str]:
    """Export one program per (device type, geometry) and write the bundle.

    `platforms`: the device types to export for ("cpu", "cuda"; default the
    parameters' own); each is exported on that device, which must be
    present.  Beam search is exported without `early_exit` (recorded so in
    bundle.json).  `dp` > 1 exports each geometry's program at B/dp rows
    (raising for a B that dp does not divide), under the global geometry's
    key.  Tracing is host work, tens of seconds
    a program at the flagship width: `workers` > 1 exports that many
    programs at a time, each in a process of its own.  Returns
    {"<platform>/<key>": program path}."""
    _check_exportable(gcfg, dp, geometries)
    gcfg = dataclasses.replace(gcfg, early_exit=False)
    platforms = tuple(platforms or (params["embed"]["lut"].device.type,))
    table = {geometry_key(g): dict(g) for g in geometries}
    # each program decodes one device's rows of the global geometry
    tasks = [(p, k, dict(g, B=g["B"] // dp)) for p in platforms for k, g in table.items()]
    for p in platforms:
        resolve_device(p)
        os.makedirs(os.path.join(path, "programs", p), exist_ok=True)
    if workers > 1 and len(tasks) > 1:
        import concurrent.futures
        import multiprocessing

        flat = flatten_params(params)
        with concurrent.futures.ProcessPoolExecutor(
                min(workers, len(tasks)),
                mp_context=multiprocessing.get_context("spawn")) as pool:
            futures = {f"{p}/{k}": pool.submit(_export_worker, path, flat, cfg, gcfg, p, k, g)
                       for p, k, g in tasks}
            seconds = {name: f.result() for name, f in futures.items()}
    else:
        seconds = {f"{p}/{k}": _export_one(path, params, cfg, gcfg, p, k, g)
                   for p, k, g in tasks}
    np.savez(os.path.join(path, "params.npz"), **flatten_params(params))
    with open(os.path.join(path, "vocab.json"), "w") as f:
        json.dump(vocab, f)
    with open(os.path.join(path, "bundle.json"), "w") as f:
        json.dump({"format": FORMAT, "model": config_to_dict(cfg),
                   "generate": config_to_dict(gcfg), "geometries": table, "dp": dp,
                   "torch_version": torch.__version__, "platforms": list(platforms),
                   "export_seconds": seconds, "export_workers": workers},
                  f, indent=1)
    return {f"{p}/{k}": os.path.join(path, "programs", p, k + ".pt2") for p, k, _ in tasks}


@dataclasses.dataclass
class Bundle:
    """A loaded serving bundle: weights, vocabulary and one program per
    geometry, on `device`."""

    cfg: ModelConfig
    gcfg: GenerateConfig
    vocab: Dict[str, int]
    params: Any
    programs: Dict[str, torch.export.ExportedProgram]
    modules: Dict[str, torch.nn.Module]      # key -> programs[key].module()
    geometries: Dict[str, Dict[str, Any]]
    platforms: List[str]
    device: torch.device
    path: str = ""
    load_seconds: Dict[str, float] = dataclasses.field(default_factory=dict)
    dp: int = 1
    _moved: Dict[torch.device, Dict[str, torch.nn.Module]] = dataclasses.field(
        default_factory=dict, repr=False)
    _lock: Any = dataclasses.field(default_factory=threading.Lock, repr=False)

    def reload_params(self) -> None:
        """Read the bundle's params.npz again (a weight refresh: the programs
        take the parameters as arguments, so nothing is exported again).  A
        Responder made before keeps the parameters it was made with."""
        with np.load(os.path.join(self.path, "params.npz")) as z:
            self.params = unflatten_params(dict(z), self.cfg, self.device)

    def modules_on(self, device) -> Dict[str, torch.nn.Module]:
        """The programs' modules on `device`: the loaded ones on the bundle's
        device; for another card, the programs loaded again from the bundle
        and moved there (`move_to_device_pass`, which rewrites a program in
        place), once, and kept."""
        from bist_tpu_torch.parallel.mesh import canonical_device

        device = canonical_device(device)
        if device == canonical_device(self.device):
            return self.modules
        with self._lock:
            if device not in self._moved:
                from torch.export.passes import move_to_device_pass

                self._moved[device] = {
                    k: move_to_device_pass(torch.export.load(os.path.join(
                        self.path, "programs", device.type, k + ".pt2")), device).module()
                    for k in self.programs}
            return self._moved[device]

    def beam_fn(self):
        """(params, batch) -> BeamResult (beam bundles) or (B, maxlen) ids
        (greedy bundles): the program of the batch's geometry on a device
        batch, on the batch's device.  A dp bundle's batch is one device's
        rows: its geometry is the global one with B·dp rows.  Raises KeyError
        for a geometry the bundle does not carry: nothing is traced at serve
        time."""
        greedy = self.gcfg.decode_style == "greedy"
        dp = self.dp

        def call(params, batch: Batch):
            geom = geometry_of(batch)
            key = geometry_key(dict(geom, B=geom["B"] * dp))
            programs = self.modules_on(batch.query.device)
            if key not in programs:
                raise KeyError(f"no exported program for geometry {key}; bundle has "
                               f"{sorted(programs)}: re-export with this geometry in "
                               f"`geometries`")
            out = programs[key](*[t for _, t in _paths(params)],
                                *[x for x in batch if x is not None])
            return out if greedy else beam.BeamResult(*out)

        return call

    def make_responder(self, **kw):
        """A `serving.Responder` on this bundle's programs, its batch, length
        and time buckets derived from the geometry table, so that it only
        assembles shapes the bundle carries."""
        from bist_tpu_torch.serving import Responder

        geoms = list(self.geometries.values())
        kw.setdefault("batch_buckets", tuple(sorted({g["B"] for g in geoms})))
        kw.setdefault("max_batch", max(g["B"] for g in geoms))
        kw.setdefault("len_buckets", {
            "q": tuple(sorted({g["Lq"] for g in geoms})),
            "h": tuple(sorted({g["Lh"] for g in geoms})),
            "c": tuple(sorted({g["Lc"] for g in geoms if "Lc" in g})),
        })
        kw.setdefault("time_buckets",
                      tuple(sorted({g["T"] for g in geoms if "T" in g})) or (16,))
        kw.setdefault("audio_time_buckets",
                      tuple(sorted({g["Ta"] for g in geoms if "Ta" in g})) or None)
        vid = next((g for g in geoms if "T" in g), None)
        if vid is not None:
            kw.setdefault("feat_tail", (vid["S"], vid["Dv"]))
        kw.setdefault("feat_int8", any(g.get("int8") for g in geoms))
        kw.setdefault("beam_fn_devices", self.dp)    # the devices the rows split over
        return Responder(self.params, self.cfg, self.vocab, self.gcfg,
                         beam_fn=self.beam_fn(), **kw)


def load_bundle(path: str, device=None) -> Bundle:
    """Load a bundle onto `device` (default cuda; raises without it).  The
    bundle must carry programs exported on that device type."""
    device = resolve_device(device)
    with open(os.path.join(path, "bundle.json")) as f:
        meta = json.load(f)
    if meta.get("format") != FORMAT:
        raise ValueError(f"not a {FORMAT} bundle: format {meta.get('format')!r}")
    platforms = list(meta["platforms"])
    if device.type not in platforms:
        raise ValueError(f"bundle {path} holds programs exported on {platforms}, "
                         f"not on {device.type}: export it with platforms=(..., "
                         f"{device.type!r})")
    cfg = model_config_from_dict(meta["model"])
    gcfg = GenerateConfig(**meta["generate"])
    with open(os.path.join(path, "vocab.json")) as f:
        vocab = {k: int(v) for k, v in json.load(f).items()}
    with np.load(os.path.join(path, "params.npz")) as z:
        params = unflatten_params(dict(z), cfg, device)
    programs, modules, seconds = {}, {}, {}
    for key in meta["geometries"]:
        t0 = time.perf_counter()
        programs[key] = torch.export.load(
            os.path.join(path, "programs", device.type, key + ".pt2"))
        modules[key] = programs[key].module()
        seconds[key] = time.perf_counter() - t0
    return Bundle(cfg=cfg, gcfg=gcfg, vocab=vocab, params=params, programs=programs,
                  modules=modules, geometries=meta["geometries"], platforms=platforms,
                  device=device, path=path, load_seconds=seconds,
                  dp=int(meta.get("dp", 1)))
