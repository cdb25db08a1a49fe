"""The port's native batch assembler (`bist_tpu_torch.native`), its feature
store and its training loader on the CPU, held against `bist_tpu`'s on the
same .npy files: header probes, padded and truncated batches from the C++
thread pool and from the numpy fallback, `FeatureStore` with and without a
prefetch pool, and `AVSDLoader` batches.  The library is built under
build/bist_tpu_torch/, never beside its source."""

import logging
import os

import numpy as np
import pytest

import chip_smoke
from bist_tpu.data.avsd import load_avsd as jax_load_avsd
from bist_tpu.data.features import FeatureStore as JaxFeatureStore
from bist_tpu.data.loader import AVSDLoader as JaxLoader
from bist_tpu.native import loader as jax_native
from bist_tpu_torch.data.avsd import load_avsd
from bist_tpu_torch.data.features import FeatureStore
from bist_tpu_torch.data.loader import AVSDLoader
from bist_tpu_torch.native import loader as native
from bist_tpu_torch.ops._build import BUILD_DIR
from bist_tpu_torch.vocab import get_vocabulary
from torch_threads import two_threads  # noqa: F401 (autouse)

TAILS = {"tsd": (4, 8), "td": (8,)}


@pytest.fixture(params=sorted(TAILS))
def npy_files(request, tmp_path, rng):
    """Three float32 files of 5, 12 and 1 rows of one tail shape."""
    tail = TAILS[request.param]
    paths, arrays = [], []
    for i, t in enumerate((5, 12, 1)):
        a = rng.standard_normal((t,) + tail).astype(np.float32)
        paths.append(str(tmp_path / f"v{i}.npy"))
        np.save(paths[-1], a)
        arrays.append(a)
    return paths, arrays, tail


def numpy_fallback(monkeypatch):
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_build_failed", True)


def test_probe_and_assemble_match_bist_tpu(npy_files):
    """Header shapes, and batches padded (t_pad 8 > 5, 1) and truncated
    (12 > 8) by the native path, equal to bist_tpu's."""
    paths, arrays, tail = npy_files
    assert native.native_available()
    for p, a in zip(paths, arrays):
        assert native.probe_npy_shape(p) == a.shape == jax_native.probe_npy_shape(p)
    for t_pad in (8, 16):
        got = native.assemble_feature_batch(paths, t_pad, tail)
        np.testing.assert_array_equal(got, jax_native.assemble_feature_batch(paths, t_pad, tail))
        for row, a in zip(got, arrays):
            k = min(len(a), t_pad)
            np.testing.assert_array_equal(row[:k], a[:k])
            np.testing.assert_array_equal(row[k:], 0.0)


def test_assemble_into_a_given_array(npy_files):
    """`out=` (the loader's pinned grids): the batch lands in the given rows,
    the rows after them untouched; an array of another dtype is refused."""
    paths, _, tail = npy_files
    want = native.assemble_feature_batch(paths, 8, tail)
    grid = np.full((len(paths) + 1, 8) + tail, 7.0, np.float32)
    got = native.assemble_feature_batch(paths, 8, tail, out=grid[:len(paths)])
    assert np.shares_memory(got, grid)
    np.testing.assert_array_equal(grid[:len(paths)], want)
    assert (grid[-1] == 7.0).all()
    with pytest.raises(ValueError, match="C-ordered float32"):
        native.assemble_feature_batch(paths, 8, tail, out=np.empty((3, 8) + tail))


def test_numpy_fallback_matches_native_and_logs_once(npy_files, monkeypatch, caplog):
    paths, _, tail = npy_files
    want = native.assemble_feature_batch(paths, 8, tail)
    numpy_fallback(monkeypatch)
    monkeypatch.setattr(native, "_fallback_logged", False)
    with caplog.at_level(logging.WARNING, logger=native.__name__):
        native._note_fallback("no g++")
        np.testing.assert_array_equal(native.assemble_feature_batch(paths, 8, tail), want)
        assert native.probe_npy_shape(paths[1]) == (12,) + tail
        native._note_fallback("again")
    assert [r.message for r in caplog.records] == [f"{native.FALLBACK_LOG} (no g++)"]


def test_a_file_the_native_path_cannot_read_falls_back(tmp_path, caplog, monkeypatch):
    """A float64 file: the native assembler refuses it, the numpy fallback
    reads it (as float32) and says so once."""
    monkeypatch.setattr(native, "_fallback_logged", False)
    a = np.arange(24, dtype=np.float64).reshape(3, 8)
    np.save(tmp_path / "f64.npy", a)
    with caplog.at_level(logging.WARNING, logger=native.__name__):
        got = native.assemble_feature_batch([str(tmp_path / "f64.npy")], 4, (8,))
    np.testing.assert_array_equal(got[0, :3], a.astype(np.float32))
    np.testing.assert_array_equal(got[0, 3:], 0.0)
    assert any(native.FALLBACK_LOG in r.message for r in caplog.records)


def test_library_is_built_under_build_not_beside_the_source():
    assert native.native_available()
    so = native.library_path()
    assert so.parent == BUILD_DIR and so.exists()
    here = os.path.dirname(native.__file__)
    assert not [f for f in os.listdir(here) if f.endswith(".so")]


@pytest.fixture(scope="module")
def tiny_set(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("native") / "data")
    test_set = chip_smoke.write_tiny_dataset(root, 6, dict(d_model=32, att_h=4, nb_blocks=1,
                                                           nb_venc_blocks=1, nb_cenc_blocks=1),
                                             dv=24, s=4, t_max=9)
    return root, test_set


@pytest.mark.parametrize("workers", [0, 4])
def test_feature_store_and_loader_match_bist_tpu(tiny_set, workers):
    """shape_of, max_t, prefetch and get_batch of the port's store against
    bist_tpu's, then the training loader's batches over 2 epochs, with no
    prefetch pool and with 4 threads."""
    root, test_set = tiny_set
    path = os.path.join(root, "<FeaType>", "<ImageID>.npy")
    kw = dict(include_caption="summary", separate_caption=True)
    vocab = get_vocabulary(test_set, cutoff=0, include_caption="summary")
    data, jdata = load_avsd(test_set, vocab, **kw), jax_load_avsd(test_set, vocab, **kw)
    store = FeatureStore("resnext_st", path, workers=workers)
    jstore = JaxFeatureStore("resnext_st", path, workers=workers)
    vids = sorted(data.vid_set)
    for s in (store, jstore):
        s.register(vids)
    store.prefetch(vids[:3])
    for v in vids:
        assert store.shape_of(v) == jstore.shape_of(v) == store.get(v).shape
    assert store.max_t(vids) == jstore.max_t(vids)
    for t_pad in (4, 16):
        np.testing.assert_array_equal(store.get_batch(vids, t_pad), jstore.get_batch(vids, t_pad))
    lkw = dict(batch_size=4, shuffle=True, cut_a=True, seed=3, pad_batch_multiple=3,
               time_buckets=(4, 8, 16))
    loader = AVSDLoader(data, visual_stores=[store], **lkw)
    jloader = JaxLoader(jdata, visual_stores=[jstore], **lkw)
    n = 0
    for _ in range(2):
        for (b, m), (jb, jm) in zip(loader, jloader):
            assert m == jm
            for f in b._fields:
                x, y = getattr(b, f), getattr(jb, f)
                assert (x is None) == (y is None), f
                if x is not None:
                    np.testing.assert_array_equal(x, np.asarray(y), err_msg=f)
            n += 1
    assert n == 2 * len(loader)
