"""The accuracy track (port of palu_tpu/evals): perplexity, zero-shot
accuracy, the lm-eval adapter and LongBench."""

from .ppl import eval_ppl, eval_ppl_on_tokens, get_ppl_test_tokens  # noqa: F401
from .scorer import scorer, scorer_e  # noqa: F401
from .metrics import dataset2metric  # noqa: F401
from .longbench import run_longbench, DEFAULT_DATASETS  # noqa: F401
from .zero_shot import run_zero_shot, loglikelihood_batch, DEFAULT_TASKS  # noqa: F401
