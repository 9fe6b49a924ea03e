"""repro_torch.configs — model configurations the port trains."""
