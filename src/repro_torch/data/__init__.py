from repro_torch.data.synthetic import BatchFn, SyntheticMNIST

__all__ = ["BatchFn", "SyntheticMNIST"]
