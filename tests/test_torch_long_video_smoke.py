"""chip_smoke.py's phase 18 (videos of more than 64 clips: t2s hop 1 over
the clips through K1 "wide"'s kv tiles on the card) on the CPU at tiny
widths, where K1 and K2 are their plain versions: beam search eager and
through a DecodeProgram against force_plain at two widths, token for token,
over grids of 65-180 clips, one train step's gradients against
force_plain and its eager steps timed against force_plain; and how the
phase counts K1's kv-tile kernel by name."""

from types import SimpleNamespace

import torch
from torch_threads import two_threads  # noqa: F401 (autouse)

TINY = dict(nb_blocks=1, nb_venc_blocks=1, nb_cenc_blocks=1)


def test_chip_smoke_phase_long_video_on_cpu():
    import chip_smoke

    assert chip_smoke.LONG_CLIPS == (65, 180)
    narrow, wide = dict(d_model=16, att_h=2, **TINY), dict(d_model=32, att_h=4, **TINY)
    out = chip_smoke.phase_long_video(
        torch.device("cpu"), n_batches=1, B=2, dv=24, s=4,
        widths=((narrow, {"wide": 3, "whole": 3}), (wide, {"wide": 6})), train_kw=wide)
    assert set(out["generation"]) == {"16", "32"}
    for gen in out["generation"].values():
        assert gen["tokens_identical_to_plain"] == {"eager": 2, "replayed": 2}
        assert gen["replayed_k1_by_name"] == chip_smoke.K1_NONE
        assert gen["eager_launches"] == {"hop1_fwd": 0, "hop1_variants": {}}
        # grids padded to a multiple of 40 past 64 clips
        assert all(64 < t <= 200 and t % 40 == 0 for t in gen["clips"])
    step = out["train_step"]
    assert step["launches"] == (0, 0) and step["loss_rel_diff"] <= 5e-4
    assert step["variants"] == {"hop1_fwd": {}, "hop1_bwd": {}}
    assert 64 < step["clips"] <= 200
    # the train step's eager ms against force_plain: 2 runs each
    speed, runs = step["speed"], 2 * chip_smoke.LONG_TRAIN_STEPS
    assert {k: len(v) for k, v in speed["eager_ms"].items()} == {"kernels": runs, "plain": runs}
    assert speed["kernel_launches"] == {"hop1_fwd": {}, "hop1_bwd": {}}
    assert speed["breakdown"] == {}


def test_k1_ran_counts_wide_once_by_its_attention_kernel():
    """`k1_ran` on a stand-in trace: a K1 "wide" launch counted once, by its
    attention kernel, the whole group's or the kv tiles' (its GEMMs not
    counted), beside "whole" and "tiled"."""
    import chip_smoke
    from torch.autograd import DeviceType

    names = ["hop1_fwd_wide_proj_kernel<float>", "hop1_fwd_wide_attn_tiles_kernel<2, 2>",
             "hop1_fwd_wide_out_kernel", "hop1_fwd_wide_attn_kernel<8>",
             "hop1_fwd_whole_kernel<float, 4, 4, 1, 2>", "hop1_fwd_tiles_kernel<float>",
             "hop1_bwd_kernel<float>"]
    events = [SimpleNamespace(device_type=lambda: DeviceType.CUDA, name=lambda n=n: n)
              for n in names]
    prof = SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: events)))
    assert chip_smoke.k1_ran(prof) == {"whole": 1, "tiled": 1, "wide": 2}
