"""Plain PyTorch ops (``functional``) and their kernel twins."""
