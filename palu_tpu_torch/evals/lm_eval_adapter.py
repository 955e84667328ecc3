"""lm-eval (EleutherAI lm-evaluation-harness) adapter (port of
palu_tpu/evals/lm_eval_adapter.py).

The reference wraps its model in lm-eval 0.4.2's HFLM (run_lm_eval.py:15-40).
When the lm_eval package is installed, `TorchLM` plugs the port's params and
config into `lm_eval.simple_evaluate` for the exact published protocol;
otherwise use palu_tpu_torch.evals.zero_shot (built-in harness, same
loglikelihood math). The module imports without lm_eval.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from ..core.quant import QuantConfig
from .ppl import params_device
from .zero_shot import loglikelihood_batch

__all__ = ["TorchLM", "simple_evaluate"]

try:
    from lm_eval.api.model import LM as _LMBase

    _HAVE_LM_EVAL = True
except ImportError:  # an environment without lm_eval
    _LMBase = object
    _HAVE_LM_EVAL = False


class TorchLM(_LMBase):
    """lm-eval LM implementation over a palu_tpu_torch model."""

    def __init__(self, params, cfg, tokenizer, qcfg: Optional[QuantConfig] = None,
                 max_length: int = 2048, max_gen_toks: int = 256):
        if _HAVE_LM_EVAL:
            super().__init__()
        self.params = params
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.qcfg = qcfg
        self.max_length = max_length
        self.max_gen_toks = max_gen_toks
        self._engine = None  # built at the first generate_until

    # --- lm-eval API ---

    def loglikelihood(self, requests) -> List[Tuple[float, bool]]:
        reqs = []
        for req in requests:
            context, continuation = req.args
            ctx_ids = self.tokenizer(context)["input_ids"] if context else [
                self.tokenizer.bos_token_id
            ]
            cont_ids = self.tokenizer(continuation, add_special_tokens=False)[
                "input_ids"
            ]
            total = (ctx_ids + cont_ids)[-self.max_length :]
            cut = len(total) - len(cont_ids)
            reqs.append((total[:cut], total[cut:]))
        return loglikelihood_batch(self.params, self.cfg, reqs, self.qcfg)

    def loglikelihood_rolling(self, requests) -> List[float]:
        out = []
        for req in requests:
            (text,) = req.args
            ids = self.tokenizer(text)["input_ids"][: self.max_length]
            res = loglikelihood_batch(
                self.params, self.cfg, [(ids[:1], ids[1:])], self.qcfg
            )
            out.append(res[0][0])
        return out

    def _get_engine(self):
        if self._engine is None:
            from ..runtime.engine import Engine, EngineConfig

            # the engine computes in the params' dtype (the port's engine
            # takes no mixed dtypes); load_for_eval's params are bf16, the
            # JAX adapter's engine default
            self._engine = Engine(
                self.params, self.cfg,
                EngineConfig(s_max=self.max_length, batch=1, qcfg=self.qcfg,
                             dtype=self.params["embed"].dtype,
                             device=str(params_device(self.params))),
            )
        return self._engine

    def generate_until(self, requests) -> List[str]:
        """Greedy generation with stop strings (lm-eval generate_until API)
        through the latent-cache Engine, on the params' device."""
        engine = self._get_engine()
        out = []
        for req in requests:
            context, gen_kwargs = req.args
            until = list(gen_kwargs.get("until", []) or [])
            max_new = int(gen_kwargs.get("max_gen_toks", self.max_gen_toks))
            ctx_ids = np.asarray(self.tokenizer(context)["input_ids"]).reshape(-1)
            # leave room for generation inside the fixed cache
            ctx_ids = ctx_ids[-(self.max_length - max_new):]
            toks = engine.generate(
                ctx_ids.astype(np.int64)[None, :], max_new_tokens=max_new,
                eos_token_id=self.tokenizer.eos_token_id,
            )
            text = self.tokenizer.decode(toks[0], skip_special_tokens=True)
            for stop in until:
                pos = text.find(stop)
                if pos >= 0:
                    text = text[:pos]
            out.append(text)
        return out


def simple_evaluate(params, cfg, tokenizer, tasks, qcfg=None, **kw):
    """lm_eval.simple_evaluate over TorchLM (requires lm_eval installed)."""
    if not _HAVE_LM_EVAL:
        raise ImportError(
            "lm_eval is not installed; use palu_tpu_torch.evals.zero_shot.run_zero_shot"
        )
    import lm_eval

    return lm_eval.simple_evaluate(
        model=TorchLM(params, cfg, tokenizer, qcfg), tasks=tasks, **kw
    )
