"""chip_smoke.py's phase 17 (the reference's width, hop 1 through K1 "wide" on
the card) on the CPU at a tiny width, where K1 and K2 are their plain
versions: beam search eager and through a DecodeProgram against
force_plain, token for token, and the train step's gradients against
force_plain, its eager steps and a TrainProgram."""

import numpy as np
import torch


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
