"""Port parity of R-GAT's gradients against ``jax.grad``, on the relation
graphs of synthetic acm (scale=0.05, block=16, hidden=8, heads=2, the
launcher's layers=2), weights from JAX's ``init_rgat``: BLOCK (plain
autograd) and MULTIGRAPH (kernels #1/#2 at G = 1 per relation and layer,
against ``MULTIGRAPH_INTERPRET``), every parameter at rtol=1e-4,
atol=1e-5.  KERNEL (kernel #5) has no gradient in either package."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import NABackend as JNA
from repro.models.hgnn import MODELS as JMODELS
from repro_torch.convert import params_from_numpy
from repro_torch.core import NABackend
from repro_torch.models.hgnn import MODELS
from repro_torch.train import hgnn_loss_and_grads

from test_torch_rgat_train import RGAT_WIDTH, check_gradients, relation_data


@pytest.mark.parametrize("backend", [NABackend.BLOCK, NABackend.MULTIGRAPH], ids=lambda b: b.value)
def test_rgat_gradients_match_jax_grad(backend):
    check_gradients("R-GAT", backend, RGAT_WIDTH)


@pytest.mark.parametrize("name", ["R-GAT", "S-HGN"])
def test_kernel_backend_has_no_gradient_in_either_package(name):
    jdata, tdata = relation_data()
    jparams = JMODELS[name].init(jax.random.key(0), jdata, hidden=4, heads=2, layers=1)

    def jloss(p):
        return jnp.sum(JMODELS[name].forward(p, jdata, backend=JNA.KERNEL_INTERPRET))

    with pytest.raises(NotImplementedError):
        jax.grad(jloss)(jparams)
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    with pytest.raises(NotImplementedError, match="MULTIGRAPH"):
        hgnn_loss_and_grads(lambda p: MODELS[name].forward(p, tdata, backend=NABackend.KERNEL),
                            params, tdata, torch.arange(4))
