from repro_torch.models.cnn import cnn_accuracy, cnn_apply, cnn_init, cnn_loss

__all__ = ["cnn_accuracy", "cnn_apply", "cnn_init", "cnn_loss"]
