"""Port parity of S-HGN's and R-GCN's forward on the relation graphs of
small acm, weights from the JAX ``init_*`` functions (the set-up and
tolerances of tests/test_torch_models.py): S-HGN on SEGMENT, BLOCK,
KERNEL (kernel #5 with each relation's edge bias) and MULTIGRAPH against
the JAX model on the same path at atol=1e-5, rtol=1e-4 and across its
backends at 5e-4; R-GCN's mean NA (SEGMENT, its one implementation)."""
import pytest

from repro_torch.core import NABackend

from test_torch_models import BACKENDS, check_backends_agree, check_logits


@pytest.mark.parametrize("backend", list(BACKENDS), ids=lambda b: b.value)
def test_shgn_logits_match_jax(backend):
    check_logits("S-HGN", backend)


def test_shgn_kernel_backend_agrees_with_the_others():
    check_backends_agree("S-HGN")


def test_rgcn_logits_match_jax():
    check_logits("R-GCN", NABackend.SEGMENT)
