from repro_torch.adversary.heterogeneity import dirichlet_mnist

__all__ = ["dirichlet_mnist"]
