"""The ``tp`` forward tests of ``test_torch_lm_tp_forward.py`` again, on
the (2, 2) ``(data, model)`` mesh of 4 CPU ranks: the ``embed`` dim of
every weight over ``data`` as well."""
from test_torch_lm_tp_forward import *  # noqa: F401,F403  (the tests, fixtures and helpers)

SHAPE = (2, 2)
