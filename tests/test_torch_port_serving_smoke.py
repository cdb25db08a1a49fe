"""chip_smoke.py's serving phases on the CPU at a tiny width, before any
card runs them: phase 8 (the served answers against the direct ones at one
geometry, over HTTP from many clients), phase 9 (closed-loop load at the
serve CLI's defaults, a few requests) and phase 10 (the serve CLI as a
process on --port 0, then the evaluate CLI), and the serve CLI's CUDA
default and unported options."""

import os
import shutil

import pytest
import torch

import chip_smoke
from bist_tpu_torch.cli import serve

CPU = torch.device("cpu")
TINY = dict(d_model=32, att_h=4, nb_blocks=2, nb_venc_blocks=2, nb_cenc_blocks=2)
SMALL = dict(dv=24, s=4)


@pytest.fixture(scope="module")
def model_and_fields():
    return (chip_smoke.serving_model(CPU, TINY, dv=24),
            chip_smoke.serving_requests(16, t_max=9, **SMALL))


def test_serving_phase_answers_equal_direct_answers(model_and_fields):
    model, fields = model_and_fields
    out = chip_smoke.phase_serving_exact(CPU, model, fields, group=8, clients=8,
                                         t_max=9, **SMALL)
    assert out["identical"] == out["requests"] == 16 and out["errors"] == 0
    assert out["batches"] < 16 and out["hop1_fwd"] == 0
    assert out["latency_ms"]["count"] == 16


def test_serving_load_phase_reads_every_style(model_and_fields):
    model, fields = model_and_fields
    out = chip_smoke.phase_serving_load(CPU, model, fields, n_req=12, n_other=6, n_prof=4,
                                        clients=4, **SMALL)
    assert set(out) == {"beam_search", "greedy", "beam_search, encode bfloat16"}
    for name, r in out.items():
        # the bare window's readings, then the profiled window's
        for w, n in ((r, 12 if name == "beam_search" else 6), (r["profiled"], 4)):
            assert w["requests"] == n
            assert w["requests_per_s"] > 0 and w["latency_ms"]["count"] == n
            assert w["hop1_fwd"] == 0 and w["batches"] >= 1
            assert set(w["component_seconds"]) == {"coalesce_s", "assemble_s", "ship_s",
                                                   "device_wait_s", "extract_s"}
        # the table is counted, not run: nothing is captured on the CPU
        assert r["traffic_table"]["geometries"] >= 4 and r["traffic_table"]["captures"] == 0
        assert "device_busy_share" not in r                 # read bare
        assert r["profiled"]["device_busy_share"] is None   # no card here
        assert "ship_breakdown" not in r                    # card only


def test_traffic_table_crosses_every_batch_bucket_with_the_reached_buckets():
    """The table: each geometry's length and time buckets, and each
    axis-wise maximum of two of them, at every batch bucket; no other
    combination of the values."""
    def g(B, Lq, Lh, T):
        return dict(B=B, Lq=Lq, Lh=Lh, Lt=1, T=T, S=16, Dv=2048, int8=False)

    geoms = [g(8, 16, 128, 48), g(64, 32, 256, 48), g(16, 16, 256, 32)]
    table = chip_smoke.traffic_table(geoms, (8, 16, 32, 64))
    assert len(table) == 4 * 4 and all(x in table for x in geoms)
    assert len({tuple(sorted(x.items())) for x in table}) == len(table)
    assert g(32, 16, 256, 48) in table                  # the first and third joined
    assert g(32, 32, 128, 32) not in table


def test_serve_and_evaluate_cli_phase(tmp_path):
    root = str(tmp_path / "tiny")
    test_set = chip_smoke.write_tiny_dataset(root, 4, TINY, t_max=9, **SMALL)
    chip_smoke.run_generate(root, test_set, ["--undisclosed-only", "1"], CPU)
    result = os.path.join(root, "result_greedy.json")
    shutil.copy(os.path.join(root, "result.json"), result)
    out = chip_smoke.phase_serve_cli(CPU, root, result, s=4)
    assert [c for c, _ in out["serve"].values()] == [200, 200, 200, 400]
    assert out["serve_metrics"]["requests"] >= 2 and out["serve_metrics"]["errors"] == 0
    assert set(out["evaluate"]) == {"Bleu_1", "Bleu_2", "Bleu_3", "Bleu_4", "METEOR",
                                    "ROUGE_L", "CIDEr"}
    assert os.path.exists(os.path.join(root, "result_greedy.eval"))


def test_serve_cli_defaults_to_cuda_and_refuses_unported_options():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--model", "absent"])
    # bundles, data-parallel ones and reference checkpoints are ported: what
    # is left refused is a dp that does not divide the batch buckets; a
    # missing reference root is named
    with pytest.raises(SystemExit, match="not divisible by --export-dp 3"):
        serve.main(["--export-dp", "3", "--export-bundle", "absent_b", "--model", "absent",
                    "--device", "cpu"])
    with pytest.raises(FileNotFoundError, match="no such directory"):
        from bist_tpu_torch.convert import import_reference_checkpoint
        import_reference_checkpoint("absent_best.pth.tar", "absent.conf",
                                    reference_root="absent_root", device="cpu")
    with pytest.raises(FileNotFoundError):
        serve.main(["--bundle", "absent_bundle", "--device", "cpu"])
    args = serve.build_parser().parse_args([])
    assert (args.max_batch, args.pipeline_depth, args.cache_dtype, args.beam,
            args.decode_style) == (64, 4, "bfloat16", 5, "beam_search")


def test_device_busy_reads_the_raw_trace():
    """Phase 9's busy share sums the trace's device events; a CPU trace has
    none."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        torch.ones(4) + 1
    assert chip_smoke.device_busy_ms(prof) is None
