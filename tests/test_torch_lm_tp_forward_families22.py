"""The ``tp`` forward tests of ``test_torch_lm_tp_forward_families.py``
again, on the (2, 2) ``(data, model)`` mesh of 4 CPU ranks."""
from test_torch_lm_tp_forward_families import *  # noqa: F401,F403  (the tests and fixtures)

SHAPE = (2, 2)
