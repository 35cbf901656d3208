"""The SLAY decoder LM in PyTorch: layers, attention dispatch, transformer."""
