from repro_torch.optim.optimizers import (AdamState, Optimizer, adamw,
                                          apply_updates, cosine_schedule,
                                          heavy_ball, sgd)

__all__ = ["AdamState", "Optimizer", "adamw", "apply_updates",
           "cosine_schedule", "heavy_ball", "sgd"]
