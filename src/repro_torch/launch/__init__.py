"""repro_torch.launch."""
