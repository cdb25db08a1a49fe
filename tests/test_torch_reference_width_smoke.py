"""chip_smoke.py's phase 17 (the reference's width, hop 1 through K1 and K2
"wide" on the card) on the CPU at a tiny width, where K1 and K2 are their
plain versions: beam search eager and through a DecodeProgram against
force_plain, token for token, and the train step's gradients against
force_plain, its eager steps and a TrainProgram; and how phase 17 reads a
profiler's trace (kernels by name, the replayed step's breakdown)."""

from types import SimpleNamespace

import numpy as np
import torch
from torch_threads import two_threads  # noqa: F401 (autouse)


def test_chip_smoke_phase_reference_width_on_cpu():
    import chip_smoke

    assert chip_smoke.REFERENCE_WIDTH == {"d_model": 512, "att_h": 8}
    out = chip_smoke.phase_reference_width(torch.device("cpu"), n_batches=1, B=2, train_B=2,
                                           steps=2, model_kw=dict(d_model=32, att_h=4))
    gen, trn = out["generation"], out["training"]
    assert gen["tokens_identical_to_plain"] == {"eager": 2, "replayed": 2}
    assert set(gen["responses_per_s"]) == {"kernels_eager", "kernels_replayed",
                                           "plain_eager", "plain_replayed"}
    assert gen["replayed_k1_by_name"] == chip_smoke.K1_NONE
    check = trn["grad_check"]
    assert check["loss_rel_diff"] <= 5e-4 and check["launches"] == (0, 0)
    assert check["variants"] == {"hop1_fwd": {}, "hop1_bwd": {}}
    assert len(trn["losses"]) == 2 and all(np.isfinite(trn["losses"]))
    assert trn["program"]["geometries"] >= 1
    # no kernel on the CPU: no launch by kernel, no trace, no breakdown
    assert trn["eager_launches"] == {"hop1_fwd": {}, "hop1_bwd": {}}
    assert trn["replayed_by_name"] is None and trn["replayed_breakdown"] == {}
    assert trn["graph_pool_mb"] == trn["program"]["pool_bytes"] / 2 ** 20


def test_step_breakdown_sorts_a_trace_by_kernel():
    """`step_breakdown` on a stand-in for a profiler's key averages over 2
    replayed steps: K1's and K2's kernels apart, by name, the others by
    time (two names alike in their first 80 characters summed), all in
    device ms a step; events without device time left out."""
    import chip_smoke

    us = {"void hop1_fwd_wide_proj_kernel<float>(...)": 2000.0,
          "void (anonymous namespace)::hop1_fwd_wide_attn_kernel<8>(...)": 400.0,
          "void hop1_bwd_wide_dw_kernel<float>(...)": 3000.0,
          "void (anonymous namespace)::hop1_bwd_wide_attn_kernel<8>(...)": 1000.0,
          "sum_middle_kernel(float const*, float*, long long, int, long long)": 60.0,
          "ampere_sgemm_128x64_nn": 5000.0, "elementwise_kernel": 700.0,
          "Memcpy DtoD": 100.0, "cudaLaunchKernel": 0.0,
          "x" * 80 + "<float>": 300.0, "x" * 80 + "<double>": 900.0}
    prof = SimpleNamespace(key_averages=lambda: [
        SimpleNamespace(key=k, self_device_time_total=v) for k, v in us.items()])
    out = chip_smoke.step_breakdown(prof, 2, top=2)
    assert out["device_ms_per_step"] == sum(us.values()) / 2e3
    assert out["k1_ms"] == {"hop1_fwd_wide_proj": 1.0, "hop1_fwd_wide_attn": 0.2}
    assert out["k2_ms"] == {"hop1_bwd_wide_dw": 1.5, "hop1_bwd_wide_attn": 0.5,
                            "sum_middle": 0.03}
    assert out["k1_total_ms"] == 1.2 and out["k2_total_ms"] == 2.03
    assert out["top_other_ms"] == {"ampere_sgemm_128x64_nn": 2.5, "x" * 80: 0.6}


def test_hop1_ran_counts_k2_wide_by_its_attention_kernel():
    """`hop1_ran` on a stand-in trace: K2 "wide" counted once a launch, by
    its attention-backward kernel (its GEMMs and sums not counted), beside
    "whole" and "tiled" by their first passes and K1 by `k1_ran`'s rule."""
    import chip_smoke
    from torch.autograd import DeviceType

    names = ["hop1_bwd_wide_proj_kernel<float>", "hop1_bwd_wide_attn_kernel<8>",
             "hop1_bwd_wide_dkv_kernel<float>", "hop1_bwd_wide_dw_kernel<float>",
             "sum_middle_kernel", "hop1_bwd_whole_kernel<float, 4, 4, 1, 2>",
             "hop1_bwd_dw_whole_kernel<float, 4>", "hop1_bwd_kernel<float>",
             "hop1_bwd_dw_kernel<float>", "hop1_fwd_wide_attn_kernel<8>",
             "hop1_fwd_wide_proj_kernel<float>"] * 2
    events = [SimpleNamespace(device_type=lambda: DeviceType.CUDA, name=lambda n=n: n)
              for n in names]
    prof = SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: events)))
    assert chip_smoke.hop1_ran(prof) == {"k1": dict(chip_smoke.K1_NONE, wide=2),
                                        "k2": {"whole": 2, "tiled": 2, "wide": 2}}
