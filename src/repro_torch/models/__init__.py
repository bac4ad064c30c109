from repro_torch.models.cnn import cnn_accuracy, cnn_apply, cnn_init, cnn_loss
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import (chunked_xent, forward, lm_loss,
                                            logits_fn, model_init)

__all__ = ["cnn_accuracy", "cnn_apply", "cnn_init", "cnn_loss",
           "ModelConfig", "chunked_xent", "forward", "lm_loss", "logits_fn",
           "model_init"]
