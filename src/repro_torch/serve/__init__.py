"""repro_torch.serve — fixed-shape scoring (the part evaluation uses)."""
