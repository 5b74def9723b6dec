"""``repro_torch.checkpoint`` — the reference's ``.npz`` + JSON checkpoint
format (``io``)."""
