"""chip_smoke.py's phase 16 (sequence parallelism) on the CPU at tiny widths:
(a) two gloo ranks at a (1 data × 2 seq) mesh against one process, train
step and beam search, and (b) four ranks at a (1 × 2 model × 2 seq) mesh,
one step against one process."""

import numpy as np
import torch
from torch_threads import two_threads  # noqa: F401 (autouse)

TINY = dict(d_model=32, att_h=4, nb_blocks=2, nb_venc_blocks=2, nb_cenc_blocks=2)


def test_chip_smoke_phase_sequence_parallel_on_cpu(tmp_path):
    import chip_smoke

    out = chip_smoke.phase_sequence_parallel(torch.device("cpu"), str(tmp_path / "sp"), B=4,
                                             rows=4, steps=2, model_kw=TINY, tiny_B=4)
    assert out["blocks"] == {"his": chip_smoke.LH // 2, "t": out["blocks"]["t"]}
    assert out["blocks"]["t"] * 2 in chip_smoke.T_BUCKETS
    assert out["loss_rel_err"] <= 5e-4 and out["grad_max_err_over_bound"] <= 1.0
    assert out["beam_tokens_identical_rows"] == 4
    assert len(out["sp_losses"]) == 2 and all(np.isfinite(out["sp_losses"]))
    step = out["seq_collectives_a_step"]
    assert step["all_gathers"] > 0 and step["all_reduces"] > 0 and step["bytes"] > 0
    assert out["beam_seq_collectives"]["all_gathers"] > 0
    assert all(len(x) == 2 for x in out["eager_sp_step_ms"])
    assert out["tp_sp"]["loss_rel_err"] <= 5e-4
