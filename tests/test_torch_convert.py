"""The port's reference-checkpoint converter (`bist_tpu_torch.convert`) on the
CPU, held against `bist_tpu.convert` on a stand-in reference module tree
(`torch_port_reference_standin`: the reference's attribute names and
sublayer lists, weights from a seed; the mappings read attributes only),
since the reference checkout itself is not in the repo: the parameters
the two packages read from one stand-in are equal leaf for leaf, the
export walkers invert them exactly, a `torch.save`d stand-in imports from
a reference root, and the CLIs read reference-format checkpoints."""

import dataclasses
import json
import os
import pickle
import shutil
import sys

import numpy as np
import pytest
import torch

import torch_port_reference_standin as standin
from bist_tpu import convert as jax_convert
from bist_tpu import export as jax_export
from bist_tpu_torch import convert, export
from bist_tpu_torch.config import TrainConfig, save_conf
from torch_port_common import CFG_VARIANTS, configs, variant_id
from torch_threads import two_threads  # noqa: F401 (autouse)

CPU = torch.device("cpu")
HERE = os.path.dirname(os.path.abspath(__file__))


@pytest.fixture
def reference_root(tmp_path):
    """A reference root whose model/mtn.py is the stand-in; the imported
    `model` package is dropped again afterwards."""
    root = tmp_path / "reference"
    (root / "model").mkdir(parents=True)
    (root / "model" / "__init__.py").write_text("")
    shutil.copy(os.path.join(HERE, "torch_port_reference_standin.py"),
                root / "model" / "mtn.py")
    yield str(root)
    for name in [m for m in sys.modules if m == "model" or m.startswith("model.")]:
        del sys.modules[name]


def same_params(got, want):
    a, b = export.flatten_params(got), export.flatten_params(want)
    assert list(a) == list(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("kw", CFG_VARIANTS, ids=[variant_id(k) for k in CFG_VARIANTS])
def test_params_from_torch_model_matches_bist_tpu(kw):
    """Both packages read the same leaves from one stand-in module, and the
    set_* walkers write them back exactly."""
    jcfg, cfg = configs(dropout=0.0, **kw)
    args = convert.ref_args_from_config(cfg)
    assert vars(args) == vars(jax_convert.ref_args_from_config(jcfg))
    got_cfg = convert.config_from_ref_args(args, cfg.vocab_size, cfg.ft_sizes)
    want_cfg = jax_convert.config_from_ref_args(args, cfg.vocab_size, cfg.ft_sizes)
    assert got_cfg == cfg
    assert all(getattr(got_cfg, f.name) == getattr(want_cfg, f.name)
               for f in dataclasses.fields(want_cfg))
    model = standin.make_model(cfg.vocab_size, cfg.vocab_size, args, cfg.ft_sizes)
    got = convert.params_from_torch_model(model, cfg, CPU)
    want = jax_convert.params_from_torch_model(model, jcfg)
    flat, jflat = export.flatten_params(got), jax_export.flatten_params(want)
    assert list(flat) == list(jflat)
    for k in flat:
        np.testing.assert_array_equal(flat[k], jflat[k], err_msg=k)
    assert list(flat) == [k for k, _ in export._paths(export.param_template(cfg))]

    args.seed = 1
    rebuilt = convert.build_reference_model(got, cfg, ref_mtn=standin, args=args)
    same_params(convert.params_from_torch_model(rebuilt, cfg, CPU), got)


def test_import_reference_checkpoint(reference_root, tmp_path):
    """A stand-in saved whole with torch.save (its classes in the reference
    root) and a pickled (vocab, args) import as the stand-in's leaves and
    config; torch.Tensor.cuda, which the stand-in calls while it is
    unpickled, is the identity only during the load."""
    _, cfg = configs(dropout=0.0)
    args = convert.ref_args_from_config(cfg)
    vocab = {f"w{i}": i for i in range(cfg.vocab_size)}
    sys.path.insert(0, reference_root)
    try:
        import model.mtn as ref_mtn
        model = ref_mtn.make_model(cfg.vocab_size, cfg.vocab_size, args, cfg.ft_sizes)
        torch.save(model, tmp_path / "mtn_best.pth.tar")
    finally:
        sys.path.remove(reference_root)
    for name in ("model.mtn", "model"):
        del sys.modules[name]
    with open(tmp_path / "mtn.conf", "wb") as f:
        pickle.dump((vocab, args), f, -1)
    cuda = torch.Tensor.cuda
    params, cfg2, vocab2 = convert.import_reference_checkpoint(
        str(tmp_path / "mtn_best.pth.tar"), str(tmp_path / "mtn.conf"),
        reference_root=reference_root, device=CPU)
    assert torch.Tensor.cuda is cuda
    assert cfg2 == cfg and vocab2 == vocab
    same_params(params, convert.params_from_torch_model(model, cfg, CPU))
    with pytest.raises(FileNotFoundError, match="no such directory"):
        convert.import_reference_checkpoint(
            str(tmp_path / "mtn_best.pth.tar"), str(tmp_path / "mtn.conf"),
            reference_root=str(tmp_path / "absent"), device=CPU)


def test_convert_cli_both_directions(reference_root, tmp_path):
    """python -m bist_tpu_torch.convert: the port's checkpoint → reference
    format → the port's again, the parameters leaf-identical at the end,
    and the reference pair readable by bist_tpu's importer too."""
    from bist_tpu_torch.models.model import init_model
    from bist_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint
    from bist_tpu_torch.train.loop import TrainState

    _, cfg = configs(dropout=0.0, nb_blocks=1, nb_venc_blocks=1, nb_cenc_blocks=1)
    params = init_model(5, cfg, device=CPU)
    vocab = {"<unk>": 0, "<blank>": 1, "<sos>": 2, "<eos>": 3}
    vocab.update({f"w{i}": i for i in range(4, cfg.vocab_size)})
    native = str(tmp_path / "a" / "mtn")
    os.makedirs(os.path.dirname(native))
    save_conf(native + ".conf", vocab, cfg, TrainConfig(), {"fea_type": ["resnext_st"]})
    save_checkpoint(native + "_best", TrainState(params, {"count": 0, "mu": [], "nu": []}, 0))

    ref = str(tmp_path / "b" / "mtn")        # no output directory yet: made by the CLI
    convert._main(["to-reference", native, ref, "--reference-root", reference_root])
    assert os.path.exists(ref + "_best.pth.tar")
    with open(ref + ".conf", "rb") as f:
        vocab3, args = pickle.load(f)
    assert vocab3 == vocab and args.fea_type == ["resnext_st"]
    jparams, jcfg, jvocab = jax_convert.import_reference_checkpoint(
        ref + "_best.pth.tar", ref + ".conf", reference_root=reference_root)
    assert jvocab == vocab
    flat, jflat = export.flatten_params(params), jax_export.flatten_params(jparams)
    assert list(flat) == list(jflat)
    for k in flat:
        np.testing.assert_array_equal(flat[k], jflat[k], err_msg=k)

    back = str(tmp_path / "c" / "mtn")
    convert._main(["to-native", ref + "_best", back, "--reference-root", reference_root])
    payload = load_checkpoint(back + "_best.pt")
    same_params(payload["params"], params)
    assert len(payload["opt_state"]["mu"]) == len(flat)


def test_default_conf_and_reference_detection_match_bist_tpu(tmp_path):
    """Every --model form resolves to <prefix>.conf as in bist_tpu (and the
    port's .pt form too); a pickled .conf is the reference's, a JSON one
    the packages'."""
    for model in ("exps/mtn", "exps/mtn_best", "exps/mtn_best.pth.tar", "exps/mtn.pth.tar"):
        assert convert.default_conf_for(model) == jax_convert.default_conf_for(model) \
            == "exps/mtn.conf"
    assert convert.default_conf_for("exps/mtn_best.pt") == "exps/mtn.conf"
    _, cfg = configs()
    with open(tmp_path / "ref.conf", "wb") as f:
        pickle.dump(({"a": 0}, convert.ref_args_from_config(cfg)), f, -1)
    save_conf(str(tmp_path / "ours.conf"), {"a": 0}, cfg, TrainConfig())
    for name, want in (("ref.conf", True), ("ours.conf", False)):
        path = str(tmp_path / name)
        assert convert.is_reference_conf(path) == jax_convert.is_reference_conf(path) == want


def test_clis_read_reference_checkpoints(reference_root, tmp_path):
    """The generate CLI answers from a reference-format checkpoint what it
    answers from the port's checkpoint of the same weights; the serve CLI's
    loader and the train CLI's --init-from-ref take it too."""
    import chip_smoke
    from bist_tpu_torch.cli import generate, serve, train
    from bist_tpu_torch.config import load_conf
    from bist_tpu_torch.weights import load_params

    root = str(tmp_path / "data")
    kw = dict(d_model=32, att_h=4, nb_blocks=2, nb_venc_blocks=2, nb_cenc_blocks=2)
    test_set = chip_smoke.write_tiny_dataset(root, n_dialogs=3, model_kw=kw, dv=24, s=4,
                                             t_max=9)
    vocab, cfg, _, _ = load_conf(os.path.join(root, "mtn.conf"))
    params = load_params(os.path.join(root, "mtn.pt"), CPU)
    ref = os.path.join(root, "ref", "mtn")
    os.makedirs(os.path.dirname(ref))
    convert.export_reference_checkpoint(params, cfg, vocab, ref, reference_root,
                                        fea_type=["resnext_st"])
    common = ["--test-set", test_set, "--test-path",
              os.path.join(root, "<FeaType>", "<ImageID>.npy"), "--undisclosed-only", "1",
              "--maxlen", "5", "--device", "cpu"]
    answers = []
    for model in (["--model", os.path.join(root, "mtn")],
                  ["--model", ref + "_best", "--reference-root", reference_root]):
        out = str(tmp_path / f"result{len(answers)}.json")
        generate.main(common + model + ["--output", out])
        with open(out) as f:
            answers.append([t["answer"] for d in json.load(f)["dialogs"]
                            for t in d["dialog"]])
    assert answers[0] == answers[1] and len(answers[0]) == 3

    args = serve.build_parser().parse_args(["--model", ref + "_best", "--reference-root",
                                            reference_root])
    got, cfg2, vocab2 = serve.load_model(args, CPU)
    assert cfg2 == cfg and vocab2 == vocab
    same_params(got, params)

    with pytest.raises(SystemExit, match="no reference-format .conf"):
        train.main(["--init-from-ref", os.path.join(root, "mtn"), "--device", "cpu"])
    exp = str(tmp_path / "exp" / "mtn")
    train.main(["--fea-type", "resnext_st", "--train-path",
                os.path.join(root, "<FeaType>", "<ImageID>.npy"), "--train-set", test_set,
                "--valid-set", test_set, "--model", exp, "--num-epochs", "1",
                "--include-caption", "summary", "--dropout", "0", "--attn-dropout", "0",
                "--batch-size", "4", "--init-from-ref", ref + "_best",
                "--reference-root", reference_root, "--device", "cpu"])
    _, cfg3, _, _ = load_conf(exp + ".conf")
    assert (cfg3.d_model, cfg3.nb_blocks, cfg3.vocab_size) == \
        (cfg.d_model, cfg.nb_blocks, cfg.vocab_size)
    assert os.path.exists(exp + "_best.pt")
