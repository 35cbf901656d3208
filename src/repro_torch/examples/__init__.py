"""The port's command-line drivers: ``python -m
repro_torch.examples.train_slayformer`` and ``python -m
repro_torch.examples.serve``, the counterparts of the JAX package's
``examples/train_slayformer.py`` and ``examples/serve.py``."""
