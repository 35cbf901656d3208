"""Launch helpers: the device-mesh factories."""
