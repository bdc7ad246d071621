"""The ``tp`` decode tests of ``test_torch_lm_tp_decode.py`` again, on the
(2, 2) ``(data, model)`` mesh of 4 CPU ranks: each data rank decodes its
2 of the 4 rows."""
from test_torch_lm_tp_decode import *  # noqa: F401,F403  (the tests, fixtures and helpers)

SHAPE = (2, 2)
