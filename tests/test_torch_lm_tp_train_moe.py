"""The ``tp`` train-step tests of ``test_torch_lm_tp_train.py`` again, on
dbrx-132b's smoke config: its 4 experts over the 2 ``model`` ranks
(``ep_shard``), the router whole on every rank, the balance loss over
``data``."""
from test_torch_lm_tp_train import *  # noqa: F401,F403  (the tests, fixtures and helpers)

ARCH = "dbrx-132b"
