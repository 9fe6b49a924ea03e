"""repro_torch.models — embedding tables and the paper's four CTR models."""
