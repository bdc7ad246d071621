"""The data-mesh LM training tests of ``test_torch_lm_train_data.py`` again,
over a data mesh of 4 CPU ranks (one row a rank and microbatch)."""
from test_torch_lm_train_data import *  # noqa: F401,F403  (the tests, fixtures and helpers)

WORLD = 4
