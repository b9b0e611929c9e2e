"""Training of the amortized embedder: adversarial (``adversarial.py``)
and solver-distilled (``distill.py``), plain torch with autograd."""

from aware_tpu_torch.train.adversarial import (
    AmortizedEmbedderConfig,
    TrainConfig,
    TrainState,
    amortized_embed,
    init_train_state,
    restore_checkpoint,
    save_checkpoint,
    train_amortized_embedder,
    train_step,
)

__all__ = [
    "AmortizedEmbedderConfig",
    "TrainConfig",
    "TrainState",
    "init_train_state",
    "train_step",
    "train_amortized_embedder",
    "amortized_embed",
    "save_checkpoint",
    "restore_checkpoint",
]
