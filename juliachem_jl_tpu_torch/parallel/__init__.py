"""Multi-device runtime: one ``torch.distributed`` rank per device."""
