"""Tasks on the BiST backbone beyond AVSD dialogue (TGIF-QA VideoQA)."""

from bist_tpu_torch.tasks.tgifqa import (
    TGIFTask, TgifExample, init_tgif_model, load_tgif_tsv, make_tgif_train_step,
    tgif_forward, tgif_loss,
)
