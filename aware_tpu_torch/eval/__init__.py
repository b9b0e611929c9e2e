"""The robustness eval (the port of ``aware_tpu/eval``)."""

from aware_tpu_torch.eval.harness import run_robustness_eval, synthesize_speech_clip

__all__ = ["run_robustness_eval", "synthesize_speech_clip"]
