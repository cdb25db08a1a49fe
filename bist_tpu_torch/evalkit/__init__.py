from bist_tpu_torch.evalkit.ptb_tokenizer import ptb_tokenize
from bist_tpu_torch.evalkit.bleu import BleuScorer
from bist_tpu_torch.evalkit.rouge import rouge_l_corpus
from bist_tpu_torch.evalkit.cider import CiderScorer
from bist_tpu_torch.evalkit.meteor import meteor_corpus
from bist_tpu_torch.evalkit.harness import evaluate_coco, get_hypotheses, StopwordFilter
