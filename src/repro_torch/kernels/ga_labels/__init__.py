from repro_torch.kernels.ga_labels.ops import ga_labels

__all__ = ["ga_labels"]
