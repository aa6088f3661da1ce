"""The experiment runner: ``torch.save`` checkpoints (``checkpoint.py``),
the system that drives the steps (``system.py``) and the epoch loop
(``builder.py``)."""
