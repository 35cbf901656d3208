"""Data: deterministic, step-indexed synthetic LM streams and the paper's
22 synthetic benchmark tasks, as ``repro.data``."""
from repro_torch.data import tasks  # noqa: F401
from repro_torch.data.pipeline import (DataConfig, batch_iterator,  # noqa: F401
                                       make_batch)
