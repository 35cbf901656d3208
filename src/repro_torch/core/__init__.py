"""SLAY math in PyTorch: quadrature, feature maps, linear attention."""
