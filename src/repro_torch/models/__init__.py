from repro_torch.models.cnn import cnn_accuracy, cnn_apply, cnn_init, cnn_loss
from repro_torch.models.config import ModelConfig
from repro_torch.models.decode import make_decode_step
from repro_torch.models.transformer import (cache_init, chunked_xent, forward,
                                            lm_loss, logits_fn, model_init)

__all__ = ["cnn_accuracy", "cnn_apply", "cnn_init", "cnn_loss",
           "ModelConfig", "cache_init", "chunked_xent", "forward", "lm_loss",
           "logits_fn", "make_decode_step", "model_init"]
