"""repro_torch.core — CowClip, the scaling rules and the optimizer algebra."""
