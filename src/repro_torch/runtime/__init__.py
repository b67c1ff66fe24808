"""repro_torch.runtime."""
